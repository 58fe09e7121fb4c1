"""The pileup paint: CUDA kernel, plain versions, wrappers.

Counterpart of `deepvariant_tpu/ops/pileup_paint.py`, whose Pallas
kernel `_paint_kernel` this replaces with the hand-written CUDA kernel
in `csrc/pileup_paint.cu` (see that file for the bound and the design).
The kernel has two entry points:

- `paint_pileup`, the rows form, takes the arguments of JAX's
  `_paint_pileup` in the same order and paints the (N, R, W, 7) read
  rows of the WGS channel set (read_base, base_quality,
  mapping_quality, strand, read_supports_variant,
  base_differs_from_ref, insert_size).
- `paint_pileup_plan`, the plan form, takes the plan tensors and
  `PlanColors` and paints the whole (N, band+R, W, C) image, reference
  band included, as `encode` of JAX's `make_longread_encode_fn` does:
  any ordered list of the ten device channels, then the two alt-aligned
  diff planes in diff mode.

On CUDA tensors a wrapper launches the kernel, or raises; on CPU
tensors it computes its plain PyTorch version (`paint_pileup_reference`,
`paint_pileup_plan_reference`), which the tests hold against JAX and
`chip_smoke.py` holds the kernel against. Both entry points count their
launches in `paint_pileup.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from deepvariant_tpu_torch.ops import _build

MAX_PIXEL = 254.0
_QUAL_CAP = 40.0
_MATCH = float(int(MAX_PIXEL * 0.2))
_MISMATCH = float(int(MAX_PIXEL))
_BASE_COLORS = ((ord("A"), 250.0), (ord("G"), 180.0), (ord("T"), 100.0),
                (ord("C"), 30.0))
NUM_CHANNELS = 7  # the rows form's planes
MAX_PLANES = 12   # the plan form's: ten channels and two diff planes
_MAX_BYTES = 2**31  # the kernel indexes the image's bytes in 32 bits

# What fills a painted plane (DvKind of csrc/pileup_paint.cu).
(KIND_BASE, KIND_QUALITY, KIND_DIFFERS, KIND_MAPQ, KIND_STRAND, KIND_SUPPORT,
 KIND_TLEN, KIND_HP, KIND_AF, KIND_SUPP) = range(10)


def scale_factor(cap: float) -> np.float32:
    """254 * (1 / cap) in float32: the factor of the JAX encoder's
    `scale`, 254 * (min(v, cap) / cap), as XLA compiles it. XLA turns
    the division by the constant into a multiply by its reciprocal and
    folds the two constants, so for 30 caps up to 255 (47 among them)
    the color is not the IEEE quotient's byte; at 40 and 60 it is."""
    with np.errstate(divide="ignore"):
        return np.float32(MAX_PIXEL) * (np.float32(1) / np.float32(cap))


def _scale_lut(cap: float) -> np.ndarray:
    """`scale` of v = 0..255, with XLA's saturating conversion to uint8
    (NaN -> 0)."""
    with np.errstate(invalid="ignore"):
        v = np.minimum(np.arange(256, dtype=np.float32), np.float32(cap))
        scaled = v * scale_factor(cap)
    return np.clip(np.nan_to_num(scaled, nan=0.0), 0, 255).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class PlanColors:
    """The plan form's planes and colors, derived from PileupOptions by
    the painter (`make_examples.pileup_device.plan_colors`).

    band: reference band height. kinds: the KIND_* of each painted plane,
    in channel order. diff: whether the two alt-aligned diff planes
    follow them. band_colors: each painted plane's band color (a
    read_base plane's is not read: its band is the reference's base
    color). qual_cap, mapq_cap: base_quality_cap, mapping_quality_cap.
    base: the colors of A, G, T, C. strand: positive, negative. support:
    the colors of support codes 0..2. supp: supplementary_alignment
    false, true. hp: the haplotype_tag colors of hp <= 0, 1, 2, >= 3.
    match, mismatch: base_differs_from_ref and the diff planes."""

    band: int
    kinds: Tuple[int, ...]
    diff: bool
    band_colors: Tuple[int, ...]
    qual_cap: float
    mapq_cap: float
    base: Tuple[int, int, int, int]
    strand: Tuple[int, int]
    support: Tuple[int, int, int]
    supp: Tuple[int, int]
    hp: Tuple[int, int, int, int]
    match: int
    mismatch: int

    @property
    def planes(self) -> int:
        return len(self.kinds) + (2 if self.diff else 0)

    @functools.cached_property
    def luts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(base, quality, mapq) 256-entry uint8 tables of the plain
        version."""
        base = np.zeros(256, np.uint8)
        base[[ord(c) for c in "AGTC"]] = self.base
        return base, _scale_lut(self.qual_cap), _scale_lut(self.mapq_cap)

    def check(self):
        """Raises ValueError on what the kernel does not take."""
        if self.band < 0:
            raise ValueError(f"band must be >= 0, got {self.band}")
        if not 1 <= len(self.kinds) or self.planes > MAX_PLANES:
            raise ValueError(
                f"the paint kernel writes 1..{MAX_PLANES} planes, not "
                f"{self.planes}")
        if len(self.band_colors) != len(self.kinds) or not all(
                KIND_BASE <= k <= KIND_SUPP for k in self.kinds):
            raise ValueError(f"bad planes in {self!r}")
        colors = (*self.band_colors, *self.base, *self.strand, *self.support,
                  *self.supp, *self.hp, self.match, self.mismatch)
        if not all(0 <= c <= 255 for c in colors):
            raise ValueError(f"colors must be bytes in {self!r}")


class _PlanColorsC(ctypes.Structure):
    """`DvPlanColors` of csrc/pileup_paint.cu."""

    _fields_ = [("band", ctypes.c_int32), ("planes", ctypes.c_int32),
                ("diff", ctypes.c_int32), ("qual_cap", ctypes.c_float),
                ("qual_scale", ctypes.c_float), ("mapq_cap", ctypes.c_float),
                ("mapq_scale", ctypes.c_float),
                ("kinds", ctypes.c_uint8 * MAX_PLANES),
                ("band_colors", ctypes.c_uint8 * MAX_PLANES),
                ("base", ctypes.c_uint8 * 4), ("strand", ctypes.c_uint8 * 2),
                ("support", ctypes.c_uint8 * 3), ("supp", ctypes.c_uint8 * 2),
                ("hp", ctypes.c_uint8 * 4), ("match", ctypes.c_uint8),
                ("mismatch", ctypes.c_uint8)]


def plan_colors_struct(colors: PlanColors) -> _PlanColorsC:
    """`colors` as the kernel's entry point takes them."""
    pad = (0,) * (MAX_PLANES - len(colors.kinds))
    return _PlanColorsC(
        colors.band, colors.planes, int(colors.diff), colors.qual_cap,
        scale_factor(colors.qual_cap), colors.mapq_cap,
        scale_factor(colors.mapq_cap), tuple(colors.kinds) + pad,
        tuple(colors.band_colors) + pad, tuple(colors.base),
        tuple(colors.strand), tuple(colors.support), tuple(colors.supp),
        tuple(colors.hp), colors.match, colors.mismatch)


def _base_color(b):
    base = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    for code, color in _BASE_COLORS:
        base = torch.where(b == code, color, base)
    return base


def paint_pileup_reference(b, q, covered, ref_windows, mapq_color,
                           strand_color, support_color, tlen_color):
    """Plain PyTorch paint: (N, R, W) inputs -> (N, R, W, 7) uint8.

    The float32 operations of JAX's `_channels_for_tile`, in its order."""
    qual = MAX_PIXEL * torch.clamp(q.to(torch.float32), max=_QUAL_CAP) \
        / _QUAL_CAP
    differs = torch.where(b == ref_windows[:, None, :], _MATCH, _MISMATCH)
    planes = [
        _base_color(b),
        qual,
        mapq_color[:, :, None].expand(b.shape),
        strand_color[:, :, None].expand(b.shape),
        support_color[:, :, None].expand(b.shape),
        differs,
        tlen_color[:, :, None].expand(b.shape),
    ]
    out = torch.stack(planes, dim=-1)
    mask = covered.to(torch.float32)[..., None]
    return (out * mask).to(torch.int32).to(torch.uint8)


def _saturate_uint8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint8 as XLA converts: truncate, saturate at 0 and 255
    (torch's own cast wraps out-of-range values)."""
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def _divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    # By a tensor on x's device: on CUDA, torch divides by a Python
    # scalar as a multiply by its reciprocal, which is not IEEE division.
    return x / x.new_full((), divisor)


def _support_color(support, colors: PlanColors):
    # JAX indexing wraps a negative index once, then clamps.
    index = support.to(torch.int64)
    index = torch.where(index < 0, index + 3, index).clamp(0, 2)
    return torch.where(
        index == 0, colors.support[0],
        torch.where(index == 1, colors.support[1], colors.support[2]))


def _tlen_color(tlen):
    # abs wraps in int32 as JAX's does: abs(-2**31) stays -2**31 and its
    # color saturates to 0.
    tlen_f = torch.clamp(torch.abs(tlen), max=1000).to(torch.float32)
    return _saturate_uint8(_divide(MAX_PIXEL * tlen_f, 1000.0))


def rows_form_args(bases, quals, mapq, rev, tlen, support, row_valid,
                   ref_windows, colors: PlanColors):
    """The arguments of `paint_pileup` for these plan rows: the coverage
    mask and the four (N, R) float32 row colors, computed as
    pileup_jax.py:563-633 does (uint8 colors, saturated)."""
    covered = (bases != 0) & row_valid[:, :, None]
    mapq_color = torch.from_numpy(colors.luts[2]).to(mapq.device)[
        mapq.long()]
    strand_color = torch.where(rev, colors.strand[1], colors.strand[0])
    return (bases, quals, covered, ref_windows,
            *[c.to(torch.float32) for c in (
                mapq_color, strand_color, _support_color(support, colors),
                _tlen_color(tlen))])


def paint_pileup_plan_reference(bases, quals, mapq, rev, hp, tlen, supp,
                                support, af, row_valid, ref_windows,
                                alt_bases, alt_row_valid, alt_ref,
                                alt_present, colors: PlanColors):
    """Plain PyTorch plan form: -> (N, band+R, W, colors.planes) uint8.

    One plane per kind as `encode` of JAX's make_longread_encode_fn
    paints it (pileup_jax.py:592-675), the band above the read rows. The
    quality and mapq colors are table lookups (the tables come from
    numpy), so only the insert-size color is float arithmetic here."""
    n, rows, width = bases.shape
    device = bases.device
    base_lut, qual_lut, mapq_lut = (
        torch.from_numpy(lut).to(device) for lut in colors.luts)
    hp_lut = torch.tensor(colors.hp, dtype=torch.uint8, device=device)
    covered = (bases != 0) & row_valid[:, :, None]

    def byte(x):
        return torch.as_tensor(x, device=device).to(torch.uint8)

    def row_plane(color):  # (N, R) -> (N, R, W)
        return byte(color)[:, :, None].expand(n, rows, width)

    def with_band(band_plane, plane):  # (N, W) or a color, (N, R, W)
        if not isinstance(band_plane, torch.Tensor):
            band_plane = torch.full((n, width), band_plane,
                                    dtype=torch.uint8, device=device)
        return torch.cat([
            band_plane[:, None, :].expand(n, colors.band, width), plane],
            dim=1)

    painters = {
        KIND_BASE: lambda: base_lut[bases.long()],
        KIND_QUALITY: lambda: qual_lut[quals.long()],
        KIND_DIFFERS: lambda: byte(torch.where(
            bases == ref_windows[:, None, :], colors.match,
            colors.mismatch)),
        KIND_MAPQ: lambda: row_plane(mapq_lut[mapq.long()]),
        KIND_STRAND: lambda: row_plane(
            torch.where(rev, colors.strand[1], colors.strand[0])),
        KIND_SUPPORT: lambda: row_plane(_support_color(support, colors)),
        KIND_TLEN: lambda: row_plane(_tlen_color(tlen)),
        KIND_HP: lambda: row_plane(hp_lut[hp.long().clamp(0, 3)]),
        KIND_AF: lambda: row_plane(af),
        KIND_SUPP: lambda: row_plane(
            torch.where(supp, colors.supp[1], colors.supp[0])),
    }
    zero = torch.zeros((), dtype=torch.uint8, device=device)
    planes = []
    for kind, band_color in zip(colors.kinds, colors.band_colors):
        plane = torch.where(covered, painters[kind](), zero)
        planes.append(with_band(
            base_lut[ref_windows.long()] if kind == KIND_BASE
            else band_color, plane))
    if colors.diff:
        alt_cov = (alt_bases != 0) & alt_row_valid[:, :, :, None]
        alt_diff = byte(torch.where(alt_bases == alt_ref[:, :, None, :],
                                    colors.match, colors.mismatch))
        alt_diff = torch.where(alt_cov, alt_diff, zero)  # (N, 2, R, W)
        for k in range(2):
            plane = with_band(colors.match, alt_diff[:, k])
            planes.append(torch.where(alt_present[:, k, None, None], plane,
                                      zero))
    return torch.stack(planes, dim=-1)


def _check(name_tensor_dtype_shape, device):
    for name, t, dtype, shape in name_tensor_dtype_shape:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the paint runs on cuda or cpu, not {device}")


def _dims(b, name):
    if not isinstance(b, torch.Tensor) or b.dim() != 3:
        raise ValueError(f"{name} must be an (N, R, W) tensor")
    return tuple(b.shape)


def _kernel(entry):
    lib = _build.load("pileup_paint")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        if entry == "dv_pileup_paint":
            inputs = [ctypes.c_void_p] * 8
        else:
            inputs = [ctypes.c_void_p] * 15 + [ctypes.POINTER(_PlanColorsC)]
        fn.argtypes = inputs + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry, inputs, device, n, rows, width, height, planes):
    """Allocate the (n, height, width, planes) output and launch `entry`
    on the current stream; raises if the launch fails."""
    if n * height * width * planes >= _MAX_BYTES:
        raise ValueError(f"{n}x{height}x{width}x{planes} bytes exceed the "
                         f"kernel's {_MAX_BYTES}")
    out = torch.empty((n, height, width, planes), dtype=torch.uint8,
                      device=device)
    if n * height * width == 0:
        return out
    fn = _kernel(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*inputs, out.data_ptr(), n, rows, width, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    paint_pileup.launches += 1
    return out


def paint_pileup(b, q, covered, ref_windows, mapq_color, strand_color,
                 support_color, tlen_color):
    """(N, R, W, 7) uint8 channel block for the read rows.

    b, q: (N, R, W) uint8; covered: (N, R, W) bool; ref_windows: (N, W)
    uint8; the four colors: (N, R) float32. All on one device and
    contiguous."""
    n, r, w = _dims(b, "b")
    _check([("b", b, torch.uint8, (n, r, w)),
            ("q", q, torch.uint8, (n, r, w)),
            ("covered", covered, torch.bool, (n, r, w)),
            ("ref_windows", ref_windows, torch.uint8, (n, w))] +
           [(name, t, torch.float32, (n, r)) for name, t in (
               ("mapq_color", mapq_color), ("strand_color", strand_color),
               ("support_color", support_color),
               ("tlen_color", tlen_color))], b.device)
    if b.device.type == "cpu":
        return paint_pileup_reference(b, q, covered, ref_windows,
                                      mapq_color, strand_color,
                                      support_color, tlen_color)
    inputs = [t.data_ptr() for t in (b, q, covered, ref_windows, mapq_color,
                                     strand_color, support_color,
                                     tlen_color)]
    return _launch("dv_pileup_paint", inputs, b.device, n, r, w, r,
                   NUM_CHANNELS)


def paint_pileup_plan(bases, quals, mapq, rev, hp, tlen, supp, support, af,
                      row_valid, ref_windows, alt_bases, alt_row_valid,
                      alt_ref, alt_present, colors: PlanColors):
    """(N, band+R, W, colors.planes) uint8 image of these plan rows.

    The tensors come in the plan's key order. bases, quals: (N, R, W)
    uint8; mapq, af: (N, R) uint8; rev, supp, row_valid: (N, R) bool; hp,
    support: (N, R) int8; tlen: (N, R) int32; ref_windows: (N, W) uint8.
    With colors.diff also alt_bases (N, 2, R, W) uint8, alt_row_valid
    (N, 2, R) bool, alt_ref (N, 2, W) uint8 and alt_present (N, 2) bool;
    without it those four are not read and may be None. All on one
    device and contiguous."""
    n, r, w = _dims(bases, "bases")
    if not isinstance(colors, PlanColors):
        raise ValueError(f"colors must be PlanColors, got {colors!r}")
    colors.check()
    named = [("bases", bases, torch.uint8, (n, r, w)),
             ("quals", quals, torch.uint8, (n, r, w)),
             ("mapq", mapq, torch.uint8, (n, r)),
             ("rev", rev, torch.bool, (n, r)),
             ("hp", hp, torch.int8, (n, r)),
             ("tlen", tlen, torch.int32, (n, r)),
             ("supp", supp, torch.bool, (n, r)),
             ("support", support, torch.int8, (n, r)),
             ("af", af, torch.uint8, (n, r)),
             ("row_valid", row_valid, torch.bool, (n, r)),
             ("ref_windows", ref_windows, torch.uint8, (n, w))]
    alt = [("alt_bases", alt_bases, torch.uint8, (n, 2, r, w)),
           ("alt_row_valid", alt_row_valid, torch.bool, (n, 2, r)),
           ("alt_ref", alt_ref, torch.uint8, (n, 2, w)),
           ("alt_present", alt_present, torch.bool, (n, 2))]
    if colors.diff:
        named += alt
    _check(named, bases.device)
    tensors = [t for _, t, _, _ in named]
    if bases.device.type == "cpu":
        return paint_pileup_plan_reference(
            *tensors, *([] if colors.diff else [None] * 4), colors)
    inputs = [t.data_ptr() for t in tensors] + (
        [] if colors.diff else [None] * 4) + [plan_colors_struct(colors)]
    return _launch("dv_pileup_paint_plan", inputs, bases.device, n, r, w,
                   colors.band + r, colors.planes)


paint_pileup.launches = 0

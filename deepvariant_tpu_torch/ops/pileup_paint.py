"""The 7-channel WGS pileup paint: CUDA kernel, plain versions, wrappers.

Counterpart of `deepvariant_tpu/ops/pileup_paint.py`, whose Pallas
kernel `_paint_kernel` this replaces with the hand-written CUDA kernel
in `csrc/pileup_paint.cu` (see that file for the bound and the design).
The kernel has two entry points:

- `paint_pileup`, the rows form, takes the arguments of JAX's
  `_paint_pileup` in the same order and paints the (N, R, W, 7) read
  rows.
- `paint_pileup_plan`, the plan form, takes the WGS plan tensors and
  `PlanColors` and paints the whole (N, band+R, W, 7) image, reference
  band included, as the WGS channels of JAX's
  `make_longread_encode_fn` do.

Channel order (the 7-channel WGS set, pileup.py numerics contract):
  read_base, base_quality, mapping_quality, strand,
  read_supports_variant, base_differs_from_ref, insert_size.

On CUDA tensors a wrapper launches the kernel, or raises; on CPU
tensors it computes its plain PyTorch version (`paint_pileup_reference`,
`paint_pileup_plan_reference`), which the tests hold against JAX and
`chip_smoke.py` holds the kernel against. Both entry points count their
launches in `paint_pileup.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from deepvariant_tpu_torch.ops import _build

MAX_PIXEL = 254.0
_QUAL_CAP = 40.0
_MATCH = float(int(MAX_PIXEL * 0.2))
_MISMATCH = float(int(MAX_PIXEL))
_BASE_COLORS = ((ord("A"), 250.0), (ord("G"), 180.0), (ord("T"), 100.0),
                (ord("C"), 30.0))
NUM_CHANNELS = 7
_MAX_PIXELS = 2**31  # the kernel indexes pixels in 32 bits


@dataclasses.dataclass(frozen=True)
class PlanColors:
    """The plan form's colors, derived from PileupOptions by the painter.

    band: reference band height; mapq_cap: mapping_quality_cap; strand:
    (positive, negative) strand colors; support: the colors of support
    codes 0..2; band_colors: the band's channels 1..6."""

    band: int
    mapq_cap: float
    strand: Tuple[int, int]
    support: Tuple[int, int, int]
    band_colors: Tuple[int, int, int, int, int, int]


class _PlanColorsC(ctypes.Structure):
    """`DvPlanColors` of csrc/pileup_paint.cu."""

    _fields_ = [("band", ctypes.c_int32), ("mapq_cap", ctypes.c_float),
                ("strand", ctypes.c_uint8 * 2),
                ("support", ctypes.c_uint8 * 3),
                ("band_colors", ctypes.c_uint8 * 6)]


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


def rows_form_args(bases, quals, mapq, rev, tlen, support, row_valid,
                   ref_windows, colors: PlanColors):
    """The arguments of `paint_pileup` for these plan rows: the coverage
    mask and the four (N, R) float32 row colors, computed as
    pileup_jax.py:563-633 does (uint8 colors, saturated)."""
    covered = (bases != 0) & row_valid[:, :, None]
    cap = float(colors.mapq_cap)
    mapq_color = _saturate_uint8(MAX_PIXEL * _divide(
        torch.clamp(mapq.to(torch.float32), max=cap), cap))
    strand_color = torch.where(rev, colors.strand[1], colors.strand[0])
    # JAX indexing wraps a negative index once, then clamps.
    index = support.to(torch.int64)
    index = torch.where(index < 0, index + 3, index).clamp(0, 2)
    support_color = torch.where(
        index == 0, colors.support[0],
        torch.where(index == 1, colors.support[1], colors.support[2]))
    # abs wraps in int32 as JAX's does: abs(-2**31) stays -2**31 and its
    # color saturates to 0.
    tlen_f = torch.clamp(torch.abs(tlen), max=1000).to(torch.float32)
    tlen_color = _saturate_uint8(_divide(MAX_PIXEL * tlen_f, 1000.0))
    return (bases, quals, covered, ref_windows,
            *[c.to(torch.float32) for c in (mapq_color, strand_color,
                                            support_color, tlen_color)])


def paint_pileup_plan_reference(bases, quals, mapq, rev, tlen, support,
                                row_valid, ref_windows, colors: PlanColors):
    """Plain PyTorch plan form: -> (N, band+R, W, 7) uint8. The read rows
    through `paint_pileup_reference`, the band above them."""
    rows = paint_pileup_reference(*rows_form_args(
        bases, quals, mapq, rev, tlen, support, row_valid, ref_windows,
        colors))
    n, _, width = bases.shape
    ref_plane = torch.empty((n, width, NUM_CHANNELS), dtype=torch.uint8,
                            device=bases.device)
    ref_plane[:, :, 0] = _base_color(ref_windows).to(torch.uint8)
    for k, color in enumerate(colors.band_colors):
        ref_plane[:, :, k + 1] = color
    ref_rows = ref_plane[:, None].expand(n, colors.band, width, NUM_CHANNELS)
    return torch.cat([ref_rows, rows], dim=1)


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
            inputs = [ctypes.c_void_p] * 8 + [ctypes.POINTER(_PlanColorsC)]
        fn.argtypes = inputs + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry, inputs, device, n, rows, width, height):
    """Allocate the (n, height, width, 7) output and launch `entry` on
    the current stream; raises if the launch fails."""
    if n * height * width >= _MAX_PIXELS:
        raise ValueError(f"{n}x{height}x{width} pixels exceed the kernel's "
                         f"{_MAX_PIXELS}")
    out = torch.empty((n, height, width, NUM_CHANNELS), dtype=torch.uint8,
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
    return _launch("dv_pileup_paint", inputs, b.device, n, r, w, r)


def paint_pileup_plan(bases, quals, mapq, rev, tlen, support, row_valid,
                      ref_windows, colors: PlanColors):
    """(N, band+R, W, 7) uint8 WGS image of these plan rows.

    bases, quals: (N, R, W) uint8; mapq: (N, R) uint8; rev: (N, R) bool;
    tlen: (N, R) int32; support: (N, R) int8; row_valid: (N, R) bool;
    ref_windows: (N, W) uint8. All on one device and contiguous."""
    n, r, w = _dims(bases, "bases")
    _check([("bases", bases, torch.uint8, (n, r, w)),
            ("quals", quals, torch.uint8, (n, r, w)),
            ("mapq", mapq, torch.uint8, (n, r)),
            ("rev", rev, torch.bool, (n, r)),
            ("tlen", tlen, torch.int32, (n, r)),
            ("support", support, torch.int8, (n, r)),
            ("row_valid", row_valid, torch.bool, (n, r)),
            ("ref_windows", ref_windows, torch.uint8, (n, w))],
           bases.device)
    if not isinstance(colors, PlanColors) or colors.band < 0:
        raise ValueError(f"colors must be PlanColors with band >= 0, got "
                         f"{colors!r}")
    if bases.device.type == "cpu":
        return paint_pileup_plan_reference(bases, quals, mapq, rev, tlen,
                                           support, row_valid, ref_windows,
                                           colors)
    c = _PlanColorsC(colors.band, colors.mapq_cap, tuple(colors.strand),
                     tuple(colors.support), tuple(colors.band_colors))
    inputs = [t.data_ptr() for t in (bases, quals, mapq, rev, tlen, support,
                                     row_valid, ref_windows)] + [c]
    return _launch("dv_pileup_paint_plan", inputs, bases.device, n, r, w,
                   colors.band + r)


paint_pileup.launches = 0

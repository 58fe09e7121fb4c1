"""The 7-channel WGS pileup paint: CUDA kernel, plain version, wrapper.

Counterpart of `deepvariant_tpu/ops/pileup_paint.py`, whose Pallas
kernel `_paint_kernel` this replaces with the hand-written CUDA kernel
in `csrc/pileup_paint.cu` (see that file for the bound and the design).

Channel order (the 7-channel WGS set, pileup.py numerics contract):
  read_base, base_quality, mapping_quality, strand,
  read_supports_variant, base_differs_from_ref, insert_size.

`paint_pileup` takes the arguments of JAX's `_paint_pileup` in the same
order. On CUDA tensors it launches the kernel, or raises; on CPU
tensors it computes `paint_pileup_reference`, the plain PyTorch version
that the tests hold against JAX and `chip_smoke.py` holds the kernel
against.
"""

from __future__ import annotations

import ctypes

import torch

from deepvariant_tpu_torch.ops import _build

MAX_PIXEL = 254.0
_QUAL_CAP = 40.0
_MATCH = float(int(MAX_PIXEL * 0.2))
_MISMATCH = float(int(MAX_PIXEL))
_BASE_COLORS = ((ord("A"), 250.0), (ord("G"), 180.0), (ord("T"), 100.0),
                (ord("C"), 30.0))
NUM_CHANNELS = 7


def paint_pileup_reference(b, q, covered, ref_windows, mapq_color,
                           strand_color, support_color, tlen_color):
    """Plain PyTorch paint: (N, R, W) inputs -> (N, R, W, 7) uint8.

    The float32 operations of JAX's `_channels_for_tile`, in its order."""
    base = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    for code, color in _BASE_COLORS:
        base = torch.where(b == code, color, base)
    qual = MAX_PIXEL * torch.clamp(q.to(torch.float32), max=_QUAL_CAP) \
        / _QUAL_CAP
    differs = torch.where(b == ref_windows[:, None, :], _MATCH, _MISMATCH)
    planes = [
        base,
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


def _check_inputs(b, q, covered, ref_windows, colors):
    if b.dim() != 3:
        raise ValueError(f"b must be (N, R, W), got shape {tuple(b.shape)}")
    n, r, w = b.shape
    expect = [
        ("b", b, torch.uint8, (n, r, w)),
        ("q", q, torch.uint8, (n, r, w)),
        ("covered", covered, torch.bool, (n, r, w)),
        ("ref_windows", ref_windows, torch.uint8, (n, w)),
    ] + [(name, t, torch.float32, (n, r)) for name, t in colors]
    for name, t, dtype, shape in expect:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != b.device:
            raise ValueError(
                f"{name} is on {t.device}, b is on {b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w > 1024:
        raise ValueError(f"width {w} exceeds the kernel's 1024 columns")
    return n, r, w


def _kernel():
    lib = _build.load("pileup_paint")
    fn = lib.dv_pileup_paint
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paint_pileup(b, q, covered, ref_windows, mapq_color, strand_color,
                 support_color, tlen_color):
    """(N, R, W, 7) uint8 channel block for the read rows.

    b, q: (N, R, W) uint8; covered: (N, R, W) bool; ref_windows: (N, W)
    uint8; the four colors: (N, R) float32. All on one device and
    contiguous."""
    colors = [("mapq_color", mapq_color), ("strand_color", strand_color),
              ("support_color", support_color), ("tlen_color", tlen_color)]
    n, r, w = _check_inputs(b, q, covered, ref_windows, colors)
    if b.device.type == "cpu":
        return paint_pileup_reference(b, q, covered, ref_windows,
                                      mapq_color, strand_color,
                                      support_color, tlen_color)
    if b.device.type != "cuda":
        raise ValueError(f"paint_pileup runs on cuda or cpu, not {b.device}")
    out = torch.empty((n, r, w, NUM_CHANNELS), dtype=torch.uint8,
                      device=b.device)
    if n * r == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = fn(b.data_ptr(), q.data_ptr(), covered.data_ptr(),
                 ref_windows.data_ptr(), mapq_color.data_ptr(),
                 strand_color.data_ptr(), support_color.data_ptr(),
                 tlen_color.data_ptr(), out.data_ptr(), n, r, w, stream)
    if err != 0:
        raise RuntimeError(f"pileup_paint kernel launch failed: CUDA error {err}")
    paint_pileup.launches += 1
    return out


paint_pileup.launches = 0

"""Batch norm + ReLU for training: CUDA kernels, plain version, wrapper.

InceptionV3's ConvBN ends in a training-mode batch norm (no scale, a
learned bias) and a ReLU. `batch_norm_relu` computes both: per channel
the batch's mean and biased variance over (N, H, W), the running
statistics moved in place flax's way (`ra = m * ra + (1 - m) * batch`,
the variance's batch value E[x^2] - E[x]^2 clamped at 0), and
`relu((x - mean) * rsqrt(var + eps) + bias)` in x's dtype, normalized
with the centred variance.

On a CUDA tensor it makes x channels_last and launches the hand-written
kernels of `csrc/batch_norm_relu.cu` (see that file for the bound and
the design), two forward and two backward, through a
`torch.autograd.Function` that saves x, the bias, the mean and 1 / std,
and not the output; it raises on what the kernels do not take (another
dtype, C not a multiple of 8). On a CPU tensor it computes the plain
version (`batch_norm_relu_reference`: the statistics in float32 by
hand, `torch.batch_norm`, `F.relu`), which the tests and `chip_smoke.py`
hold the kernels against. While spans are on (`utils/trace.py`) each
call counts the path it took, `batch_norm.fused` or `batch_norm.plain`;
`batch_norm_relu.launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from deepvariant_tpu_torch.ops import _build
from deepvariant_tpu_torch.utils import trace

# Threads of a block and 16-byte columns of a tile (csrc: kThreads and
# the host's tiling). A tile of up to 64 columns takes a bfloat16 row of
# up to 512 channels in one block.
THREADS = 512
MAX_COLUMNS = 64
# Blocks per SM the chunks aim at, rows a thread walks at least, and the
# divisor of M under which chunks**2 stays: every apply block merges all
# chunks' partials of its channels (chunks**2 * C values over the grid,
# from L2), so more chunks fill the card but cost merging. These three
# gave the least time summed over the network's 94 layers at batch 2,048
# on the H100 among the settings tried (PERF.md, the kernel table).
BLOCKS_PER_SM = 2
MIN_ROWS_PER_THREAD = 4
MERGE_ROWS = 3

_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernels cut an (M, C) matrix: `tiles` blocks of `vc`
    16-byte columns by `ty` row lanes across the channels, `chunks` of
    `rows_per_chunk` rows down."""

    rows: int
    channels: int
    rows_per_chunk: int
    chunks: int
    tiles: int
    vc: int
    ty: int


@functools.lru_cache(maxsize=None)
def geometry(rows: int, channels: int, itemsize: int,
             sms: int) -> Geometry:
    """The launch geometry for `rows` x `channels` elements of `itemsize`
    bytes on a card with `sms` multiprocessors."""
    cols = channels * itemsize // 16
    tiles = -(-cols // MAX_COLUMNS)
    vc = -(-cols // tiles)
    ty = THREADS // vc
    want = max(1, -(-BLOCKS_PER_SM * sms // tiles))
    most = max(1, math.isqrt(rows // MERGE_ROWS))
    fill = max(1, rows // (ty * MIN_ROWS_PER_THREAD))
    chunks = min(want, most, fill)
    per = -(-rows // chunks)
    return Geometry(rows, channels, per, -(-rows // per), tiles, vc, ty)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _update_running(running: torch.Tensor, batch: torch.Tensor,
                    momentum: float):
    running.copy_(momentum * running + (1 - momentum) * batch)


def batch_norm_train_reference(x, bias, running_mean, running_var,
                               momentum: float, eps: float):
    """The plain training-mode batch norm (no scale): statistics in
    float32 (float64 for float64 input), the running statistics moved in
    place, the output in x's dtype."""
    with torch.no_grad():
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min(
            xf.square().mean(dim=(0, 2, 3)) - mean.square(), 0.0)
        del xf
        _update_running(running_mean, mean, momentum)
        _update_running(running_var, var, momentum)
    # The normalization itself (float32 inside, the output in the input's
    # dtype, as flax casts it) and its gradient through the batch
    # statistics; torch.batch_norm, as flax, also takes one value per
    # channel (F.batch_norm refuses it). The scale is an explicit 1:
    # CUDA's backward for a bfloat16 input returns no bias gradient
    # without one.
    return torch.batch_norm(x, torch.ones_like(bias), bias, None, None,
                            True, 0.0, eps, torch.backends.cudnn.enabled)


def batch_norm_relu_reference(x, bias, running_mean, running_var,
                              momentum: float, eps: float):
    """The plain version: `batch_norm_train_reference`, then the ReLU."""
    return F.relu(batch_norm_train_reference(x, bias, running_mean,
                                             running_var, momentum, eps))


def _kernel(entry):
    fn = getattr(_build.load("batch_norm_relu"), entry)
    if fn.argtypes is None:
        ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_double)
        if entry == "dv_batch_norm_relu_forward":
            fn.argtypes = [i32] + [ptr] * 8 + [i64] + [i32] * 6 + \
                [f64] * 3 + [ptr]
        else:
            fn.argtypes = [i32, ptr, ptr, i64] + [ptr] * 6 + [i64] + \
                [i32] * 6 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry, x, *args):
    """Calls `entry` with `args` and the current stream of x's device,
    whose raw pointer is the cheapest to read on every step; the device
    is switched only where x is not on the current one."""
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(entry, x, *args)
    return _kernel(entry)(*args, torch._C._cuda_getCurrentRawStream(index))


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _check(x, bias, running_mean, running_var):
    """Raises on what the kernels do not take; returns the accumulator
    dtype."""
    if x.dtype not in _DTYPES:
        raise TypeError("the batch norm kernels take bfloat16, float32 or "
                        f"float64, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    channels = x.shape[1]
    if channels % 8:
        raise ValueError(f"the channels ({channels}) must be a multiple "
                         "of 8")
    if not x.is_contiguous(memory_format=torch.channels_last) or \
            not _aligned(x):
        raise ValueError("x must be channels_last, dense and 16-byte "
                         "aligned")
    if x.numel() == 0:
        raise ValueError("x is empty")
    acc = torch.promote_types(x.dtype, torch.float32)
    for name, t in (("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.dtype != acc or t.shape != (channels,) or \
                not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be a contiguous ({channels},) "
                             f"{acc} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return acc


def _row_stride(t: torch.Tensor):
    """t's row stride as an (N*H*W, C) matrix with unit channel stride,
    the rows evenly spaced, or None."""
    n, c, h, w = t.shape
    s = t.stride()
    ld = s[3] if w > 1 else s[2] if h > 1 else s[0] if n > 1 else c
    if (c == 1 or s[1] == 1) and (w == 1 or s[3] == ld) and \
            (h == 1 or s[2] == w * ld) and (n == 1 or s[0] == h * w * ld) \
            and ld >= c:
        return ld
    return None


def forward_kernel(x, bias, running_mean, running_var, momentum: float,
                   eps: float):
    """The forward on the card: (y, mean, rstd), the running statistics
    moved in place. Two launches."""
    acc = _check(x, bias, running_mean, running_var)
    n, c, h, w = x.shape
    g = geometry(n * h * w, c, x.element_size(), _sms(x.device.index
                                                      or 0))
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(c, dtype=acc, device=x.device)
    rstd = torch.empty(c, dtype=acc, device=x.device)
    part = torch.empty(3 * g.chunks * c, dtype=acc, device=x.device)
    err = _launch(
        "dv_batch_norm_relu_forward", x, _DTYPES[x.dtype], x.data_ptr(),
        y.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        part.data_ptr(), g.rows, c, g.rows_per_chunk, g.chunks, g.tiles,
        g.vc, g.ty, momentum, 1 - momentum, eps)
    if err != 0:
        raise RuntimeError(f"batch norm forward kernels failed: CUDA error "
                           f"{err}")
    batch_norm_relu.launches += 2
    return y, mean, rstd


def backward_kernel(dy, x, bias, mean, rstd):
    """The backward on the card: (dx, dbias). Two launches. dy may be a
    channel slice of a wider channels_last tensor; another layout is
    made channels_last first."""
    n, c, h, w = x.shape
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    ld = _row_stride(dy)
    if ld is None or not _aligned(dy) or (ld * dy.element_size()) % 16:
        dy = dy.contiguous(memory_format=torch.channels_last)
        ld = c
    g = geometry(n * h * w, c, x.element_size(), _sms(x.device.index or 0))
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dbias = torch.empty_like(bias)
    part = torch.empty(2 * g.chunks * c, dtype=mean.dtype, device=x.device)
    err = _launch(
        "dv_batch_norm_relu_backward", x, _DTYPES[x.dtype], x.data_ptr(),
        dy.data_ptr(), ld, dx.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        bias.data_ptr(), part.data_ptr(), dbias.data_ptr(), g.rows, c,
        g.rows_per_chunk, g.chunks, g.tiles, g.vc, g.ty)
    if err != 0:
        raise RuntimeError(f"batch norm backward kernels failed: CUDA error "
                           f"{err}")
    batch_norm_relu.launches += 2
    return dx, dbias


class _BatchNormReLU(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bias, running_mean, running_var, momentum, eps):
        y, mean, rstd = forward_kernel(x, bias, running_mean, running_var,
                                       momentum, eps)
        ctx.save_for_backward(x, bias, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, bias, mean, rstd = ctx.saved_tensors
        dx, dbias = backward_kernel(dy, x, bias, mean, rstd)
        return dx, dbias, None, None, None, None


def batch_norm_relu(x, bias, running_mean, running_var, momentum: float,
                    eps: float):
    """relu(batch_norm(x)) in training mode, the running statistics moved
    in place: the kernels for a CUDA tensor (counted `batch_norm.fused`
    while spans are on), the plain version for a CPU one
    (`batch_norm.plain`). The kernels read channels_last, the network's
    layout; another (CUDA's float64 convolutions return one) is made
    channels_last first."""
    if x.is_cuda:
        trace.count("batch_norm.fused")
        x = x.contiguous(memory_format=torch.channels_last)
        return _BatchNormReLU.apply(x, bias, running_mean, running_var,
                                    momentum, eps)
    trace.count("batch_norm.plain")
    return batch_norm_relu_reference(x, bias, running_mean, running_var,
                                     momentum, eps)


batch_norm_relu.launches = 0

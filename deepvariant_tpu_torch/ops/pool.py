"""InceptionV3's pools: CUDA kernels, plain versions, wrappers.

`box3x3(x)` is the 3x3 stride-1 average pool with zero padding 1 that
counts the padded zeros (flax's SAME avg_pool), so it always divides by
9. That map is self-adjoint: its backward is the same pool of the
incoming gradient (torch's own avg_pool2d backward on CUDA returns wrong
gradients for channels_last input, seen with torch 2.11.0 and cuDNN 9.22
on an H100, and is never called). `max3x3s2(x)` is the 3x3 stride-2
VALID max pool.

They replace no TPU kernel: the JAX package leaves both pools to XLA.
They were added because torch's pooling kernels were the top device
entries of the train step, at some 13 times their byte floor, and
torch's max pool saved int64 indices for its backward. On a CUDA tensor
each op makes x channels_last (a channel slice of a channels_last tensor
is taken as it is) and launches the hand-written kernels of
`csrc/pool.cu`: the box filter one launch each way, the max pool one
forward (which writes y and saves nothing but x) and one backward (which
recomputes each window's maximum from x). They equal torch's CUDA
kernels bit for bit (see that file for the rule, the bound and the
design); they take bfloat16, float32 and float64 and raise on anything
else, with no fallback. On a CPU tensor each op computes the plain
version, the code before the kernels: `F.avg_pool2d` both ways, and
torch's max pool with its indices.

While spans are on (`utils/trace.py`) every pool's forward computes in
a `pool.forward` span and its backward in a `pool.backward` span (on
autograd's thread). On the card each span holds the kernel's launch
alone, so its device time is the kernel's, without the wrapper's host
time, which a host-paced step would add while the card waits.
`box3x3.launches` and `max3x3s2.launches` count the kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from deepvariant_tpu_torch.ops import _build
from deepvariant_tpu_torch.ops.batch_norm_relu import _row_stride
from deepvariant_tpu_torch.utils import trace

_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_NO_SPAN = contextlib.nullcontext()
# The max pool's kernel, stride and padding (torch's argument lists).
_WINDOW, _STRIDE, _NO_PAD, _DILATION = [3, 3], [2, 2], [0, 0], [1, 1]


def box3x3_reference(x):
    """The plain box filter: 3x3, stride 1, zero padding 1, / 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def max3x3s2_reference(x):
    """The plain max pool: 3x3, stride 2, VALID."""
    return F.max_pool2d(x, 3, stride=2)


_ENTRIES = {}


def _kernel(entry):
    fn = _ENTRIES.get(entry)
    if fn is None:
        fn = getattr(_build.load("pool"), entry)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if entry == "dv_max3x3s2_backward_nhwc":
            fn.argtypes = [i32, ptr, i64, ptr, i64, ptr, i64] + [i32] * 3 + \
                [ptr]
        else:
            fn.argtypes = [i32, ptr, i64, ptr, i64] + [i32] * 3 + [ptr]
        fn.restype = ctypes.c_int
        _ENTRIES[entry] = fn
    return fn


def _rows(t: torch.Tensor, name: str) -> int:
    """t's position stride: t must be (N, C, H, W) with unit channel
    stride and evenly spaced positions (channels_last, or a channel slice
    of it); raises otherwise, and on a dtype the kernels do not take."""
    if t.dtype not in _DTYPES:
        raise TypeError("the pool kernels take bfloat16, float32 or "
                        f"float64, not {t.dtype}")
    if t.dim() != 4 or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty (N, C, H, W) tensor, "
                         f"got {tuple(t.shape)}")
    ld = _row_stride(t)
    if ld is None:
        raise ValueError(f"{name} must be channels_last (NHWC), got "
                         f"strides {t.stride()}")
    return ld


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernels read its layout, else a channels_last
    copy."""
    if t.dim() == 4 and _row_stride(t) is not None:
        return t
    return t.contiguous(memory_format=torch.channels_last)


def _launch(entry, span, x, *args):
    """Calls `entry` with x's dtype, x, `args` (tensors as pointers) and
    the current stream of x's device, inside the span `span` (None: no
    span). Each call costs host time on every step, so this keeps to
    plain calls: the stream as torch's raw pointer, a device switch only
    where x is not on the current device."""
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(entry, span, x, *args)
    fn = _kernel(entry)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch._C._cuda_getCurrentRawStream(index)
    with trace.span(span) if span else _NO_SPAN:
        err = fn(_DTYPES[x.dtype], x.data_ptr(), *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")


def box3x3_kernel(x, span=None):
    """The box filter on the card: one launch; y is channels_last."""
    ld = _rows(x, "x")
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    _launch("dv_box3x3_nhwc", span, x, ld, y, n, c, h, w)
    box3x3.launches += 1
    return y


def _pooled(size: int) -> int:
    if size < 3:
        raise ValueError(f"the max pool needs H and W of at least 3, got "
                         f"{size}")
    return (size - 3) // 2 + 1


def max3x3s2_forward_kernel(x, span=None):
    """The max pool's forward on the card: one launch, y only."""
    ld = _rows(x, "x")
    n, c, h, w = x.shape
    y = torch.empty((n, c, _pooled(h), _pooled(w)), dtype=x.dtype,
                    device=x.device, memory_format=torch.channels_last)
    _launch("dv_max3x3s2_forward_nhwc", span, x, ld, y, n, c, h, w)
    max3x3s2.launches += 1
    return y


def max3x3s2_backward_kernel(dy, x, span=None):
    """The max pool's backward on the card: dx from the forward's x and
    dy (a channel slice of a channels_last tensor is read as it is), one
    launch."""
    ld_x = _rows(x, "x")
    n, c, h, w = x.shape
    if dy.dtype != x.dtype or dy.shape != (n, c, _pooled(h), _pooled(w)):
        raise ValueError(f"dy must be {x.dtype} "
                         f"{(n, c, _pooled(h), _pooled(w))}, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    ld_dy = _rows(dy, "dy")
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    _launch("dv_max3x3s2_backward_nhwc", span, x, ld_x, dy, ld_dy, dx, n, c,
            h, w)
    max3x3s2.launches += 1
    return dx


def _box(x, span):
    if x.is_cuda:
        return box3x3_kernel(_channels_last(x), span)
    with trace.span(span):
        return box3x3_reference(x)


class _Box3x3(torch.autograd.Function):
    """The box filter, whose backward is the box filter."""

    @staticmethod
    def forward(ctx, x):
        return _box(x, "pool.forward")

    @staticmethod
    def backward(ctx, grad):
        if torch.is_grad_enabled():
            # A graph of the gradient is asked for: the box filter again,
            # differentiable.
            return _Box3x3.apply(grad)
        return _box(grad, "pool.backward")


class _Max3x3s2(torch.autograd.Function):
    """The max pool. On the card it saves x alone; on the CPU, x and
    torch's indices."""

    @staticmethod
    def forward(ctx, x):
        if x.is_cuda:
            x = _channels_last(x)
            ctx.save_for_backward(x)
            return max3x3s2_forward_kernel(x, "pool.forward")
        with trace.span("pool.forward"):
            y, indices = torch.ops.aten.max_pool2d_with_indices(
                x, _WINDOW, _STRIDE)
        ctx.save_for_backward(x, indices)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if len(ctx.saved_tensors) == 1:
            x, = ctx.saved_tensors
            return max3x3s2_backward_kernel(_channels_last(dy), x,
                                            "pool.backward")
        x, indices = ctx.saved_tensors
        with trace.span("pool.backward"):
            return torch.ops.aten.max_pool2d_with_indices_backward(
                dy, x, _WINDOW, _STRIDE, _NO_PAD, _DILATION, False, indices)


def box3x3(x):
    """The 3x3 stride-1 average pool with its padded zeros counted: the
    kernel for a CUDA tensor, the plain version for a CPU one."""
    return _Box3x3.apply(x)


def max3x3s2(x):
    """The 3x3 stride-2 VALID max pool: the kernels for a CUDA tensor,
    the plain version for a CPU one."""
    return _Max3x3s2.apply(x)


box3x3.launches = 0
max3x3s2.launches = 0

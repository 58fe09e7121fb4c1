"""InceptionV3's pools (`ops/pool.py`, `csrc/pool.cu`): the 3x3 box
filter (SAME, padded zeros counted) and the 3x3 stride-2 VALID max pool.

On the CPU: the ops take the plain versions, which are the code before
the kernels bit for bit, and equal the JAX package's `nn.avg_pool` /
`nn.max_pool`; `gradcheck` in float64; every pool of a train step opens
a `pool.forward` and a `pool.backward` span while spans are on (13 + 13)
and nothing while they are off. The kernels' logic runs here too: the
CUDA source is compiled with the host C++ compiler against
`tests/cuda_emulation/threads/cuda_runtime.h` and held bit for bit to
`torch_cuda_rule`, this file's statement of what torch's NHWC CUDA
kernels compute (checked against torch's CPU kernels where the two
agree), at geometries the card's runs do not visit: odd H and W, 1xN
grids, C not a multiple of 8, channel slices, ties, NaNs, infinities and
negative zeros in a window, a window of nothing but -infinity.

Tests marked `chip` need a CUDA card and skip without one; they decide
inside the `card` fixture. On the card they hold both kernels to torch's
own CUDA pools bit for bit at every pool shape of the network, in
bfloat16 and float32, and check repeat runs, launch counts, the CUDA
events a step makes with spans off and on, and refusals:
`python -m pytest --noconftest tests/test_torch_pool.py -q` (this file
imports no JAX at module level; the JAX comparison skips where JAX is
absent)."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.ops import pool
from deepvariant_tpu_torch.ops.batch_norm_relu import _row_stride
from deepvariant_tpu_torch.utils import trace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "deepvariant_tpu_torch", "csrc", "pool.cu")
DTYPES = (torch.bfloat16, torch.float32, torch.float64)
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
        torch.float64: torch.int64}

# The (C, H, W) input of every pool of InceptionV3 at 100x221x7 (WGS)
# and 100x147x10 (PacBio), with how often a pass runs it;
# test_network_pool_shapes checks them.
WGS_BOX = [((192, 10, 25), 1), ((256, 10, 25), 1), ((288, 10, 25), 1),
           ((768, 4, 12), 4), ((1280, 1, 5), 1), ((2048, 1, 5), 1)]
WGS_MAX = [((64, 47, 108), 1), ((192, 21, 51), 1), ((288, 10, 25), 1),
           ((768, 4, 12), 1)]
PACBIO_BOX = [((192, 10, 16), 1), ((256, 10, 16), 1), ((288, 10, 16), 1),
              ((768, 4, 7), 4), ((1280, 1, 3), 1), ((2048, 1, 3), 1)]
PACBIO_MAX = [((64, 47, 71), 1), ((192, 21, 33), 1), ((288, 10, 16), 1),
              ((768, 4, 7), 1)]


@pytest.fixture
def card():
    """The CUDA device for tests marked `chip`; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def recorder(monkeypatch):
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    return rec


def seeded(shape, dtype, seed, device="cpu", ties=False, specials=False):
    """A seeded (N, C, H, W) tensor; `ties` draws from five values, so
    windows hold equal maxima; `specials` plants NaN, +-inf and -0."""
    rng = np.random.RandomState(seed)
    if ties:
        a = rng.randint(-2, 3, shape) * 0.5
    else:
        a = rng.standard_normal(shape) * rng.uniform(0.3, 3.0)
    t = torch.from_numpy(a).to(dtype)
    if specials:
        flat = t.view(-1)
        flat[rng.rand(flat.numel()) < 0.04] = float("nan")
        flat[rng.rand(flat.numel()) < 0.03] = float("inf")
        flat[rng.rand(flat.numel()) < 0.03] = -float("inf")
        flat[rng.rand(flat.numel()) < 0.06] = -0.0
    return t.to(device)


def nhwc(t, ld=None):
    """t channels_last, or as channels [8, 8 + C) of a channels_last
    tensor of `ld` channels."""
    if ld is None:
        return t.contiguous(memory_format=torch.channels_last)
    n, c, h, w = t.shape
    wide = torch.zeros((n, h, w, ld), dtype=t.dtype, device=t.device)
    wide[..., 8:8 + c] = t.permute(0, 2, 3, 1)
    return wide.permute(0, 3, 1, 2)[:, 8:8 + c]


def bits(t):
    return t.contiguous().view(BITS[t.dtype])


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a.cpu()), bits(b.cpu()))


def same_bits_but_nan_payloads(a, b):
    """Equal bits, NaN for NaN: the host's arithmetic keeps a NaN
    operand's sign and payload where the card's makes its canonical
    NaN."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and same_bits(
        torch.where(nan, torch.zeros_like(a), a),
        torch.where(nan, torch.zeros_like(b), b))


# -- torch's NHWC CUDA kernels, stated in Python --

def _acc(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def _narrow(a, dtype):
    """The accumulator rounded to `dtype` as torch's CUDA code rounds
    (to nearest even; bfloat16 NaN is 0x7fff on sm_80 and later)."""
    if dtype != torch.bfloat16:
        return a.to(dtype)
    b = a.view(torch.int32).to(torch.int64) & 0xffffffff
    r = (b + 0x7fff + ((b >> 16) & 1)) >> 16
    r = torch.where(torch.isnan(a), torch.full_like(r, 0x7fff), r)
    r = torch.where(r >= 0x8000, r - 0x10000, r)
    return r.to(torch.int16).view(torch.bfloat16)


def box_cuda_rule(x):
    """avg_pool2d_out_cuda_frame(_nhwc): the window's taps inside the
    image summed in the accumulator from 0 in row-major order, / 9."""
    n, c, h, w = x.shape
    xa = x.to(_acc(x.dtype))
    out = torch.empty((n, c, h, w), dtype=_acc(x.dtype))
    for i in range(h):
        for j in range(w):
            s = torch.zeros((n, c), dtype=_acc(x.dtype))
            for a in range(max(i - 1, 0), min(i + 2, h)):
                for b in range(max(j - 1, 0), min(j + 2, w)):
                    s = s + xa[:, :, a, b]
            out[:, :, i, j] = s / 9
    return _narrow(out, x.dtype)


def max_cuda_rule(x, dy):
    """max_pool_forward_nhwc and max_pool_backward_nhwc: the index starts
    at 0 and the maximum at -inf; a tap replaces it if greater or NaN.
    An input element covered by exactly one window takes that window's
    dy (or 0) as it is; any other sums the dy of the windows whose index
    it is, in the accumulator from 0 in row-major window order."""
    n, c, h, w = x.shape
    dt, acc = x.dtype, _acc(x.dtype)
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    xa, xb = x.to(acc), bits(x)
    index = torch.zeros((n, c, ho, wo), dtype=torch.int64)
    yb = torch.empty((n, c, ho, wo), dtype=BITS[dt])
    for oh in range(ho):
        for ow in range(wo):
            best = torch.full((n, c), -float("inf"), dtype=acc)
            ix = torch.zeros((n, c), dtype=torch.int64)
            got = bits(torch.full((n, c), -float("inf"), dtype=dt))
            for a in range(3):
                for b in range(3):
                    i, j = 2 * oh + a, 2 * ow + b
                    v = xa[:, :, i, j]
                    up = (v > best) | torch.isnan(v)
                    best = torch.where(up, v, best)
                    ix = torch.where(up, torch.full_like(ix, i * w + j), ix)
                    got = torch.where(up, xb[:, :, i, j], got)
            index[:, :, oh, ow] = ix
            yb[:, :, oh, ow] = got
    dya, dyb = dy.to(acc), bits(dy)
    dxb = torch.empty((n, c, h, w), dtype=BITS[dt])
    for i in range(h):
        rows = range(0 if i < 3 else (i - 3) // 2 + 1, min(i // 2 + 1, ho))
        for j in range(w):
            cols = range(0 if j < 3 else (j - 3) // 2 + 1,
                         min(j // 2 + 1, wo))
            if len(rows) == 1 and len(cols) == 1:
                hit = index[:, :, rows[0], cols[0]] == i * w + j
                g = dyb[:, :, rows[0], cols[0]]
                dxb[:, :, i, j] = torch.where(hit, g, torch.zeros_like(g))
                continue
            s = torch.zeros((n, c), dtype=acc)
            for oh in rows:
                for ow in cols:
                    hit = index[:, :, oh, ow] == i * w + j
                    s = s + torch.where(hit, dya[:, :, oh, ow],
                                        torch.zeros_like(s))
            dxb[:, :, i, j] = bits(_narrow(s, dt))
    return yb.view(dt), dxb.view(dt)


def torch_cuda_rule(x, dy=None):
    """(box(x), max pool's y, its dx for dy) as torch's NHWC CUDA
    kernels compute them."""
    y, dx = max_cuda_rule(x, dy) if dy is not None else (None, None)
    return box_cuda_rule(x), y, dx


def pooled(h, w):
    return (h - 3) // 2 + 1, (w - 3) // 2 + 1


# -- the CPU: the plain path, the JAX package, spans --


def todays_box(x):
    """`_avg_pool_same` before the kernels: a Function whose forward and
    backward are F.avg_pool2d."""
    class Box(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return F.avg_pool2d(t, 3, stride=1, padding=1,
                                count_include_pad=True)

        @staticmethod
        def backward(ctx, g):
            return F.avg_pool2d(g, 3, stride=1, padding=1,
                                count_include_pad=True)
    return Box.apply(x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("shape", [(2, 16, 10, 25), (3, 5, 7, 9),
                                   (2, 24, 4, 12), (1, 8, 3, 3)])
def test_plain_path_is_todays_code_bit_for_bit(dtype, layout, shape):
    x0 = seeded(shape, dtype, 1, ties=True)
    if layout == "channels_last":
        x0 = nhwc(x0)
    before = (pool.box3x3.launches, pool.max3x3s2.launches)
    got, want = [], []
    for op, old in ((pool.box3x3, todays_box),
                    (pool.max3x3s2, lambda t: F.max_pool2d(t, 3, stride=2))):
        for f, out in ((op, got), (old, want)):
            x = x0.clone().requires_grad_(True)
            y = f(x)
            g = seeded(tuple(y.shape), dtype, 2)
            out += [y.detach(), torch.autograd.grad(y, x, g)[0]]
    for a, b in zip(got, want):
        assert same_bits(a, b)
    assert (pool.box3x3.launches, pool.max3x3s2.launches) == before


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(2, 7, 9, 11), (1, 4, 3, 3),
                                   (2, 5, 1, 6), (3, 6, 10, 25)])
def test_plain_versions_equal_the_jax_package(ties, shape):
    # float32 (JAX computes in float32 unless x64 is switched on); XLA
    # sums the window in its own order.
    jnp = pytest.importorskip("jax.numpy")
    pytest.importorskip("flax")
    from deepvariant_tpu.models import inception_v3 as jiv3

    x = seeded(shape, torch.float32, 3, ties=ties)
    x_nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    want = np.asarray(jiv3._avg_pool_same(x_nhwc))
    got = pool.box3x3(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if shape[2] >= 3 and shape[3] >= 3:
        want = np.asarray(jiv3._max_pool_v(x_nhwc))
        got = pool.max3x3s2(x).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["box3x3", "max3x3s2"])
def test_gradcheck_float64(op):
    x = seeded((2, 3, 7, 8), torch.float64, 4).requires_grad_(True)
    assert torch.autograd.gradcheck(getattr(pool, op), (x,))


def test_box_filter_backward_is_differentiable():
    # The backward is the box filter itself, so a second derivative
    # exists (the map is linear: its gradient does not depend on x).
    x = seeded((1, 2, 5, 6), torch.float64, 5).requires_grad_(True)
    assert torch.autograd.gradgradcheck(pool.box3x3, (x,))


def test_max_pool_refuses_grids_under_three():
    with pytest.raises(RuntimeError):
        pool.max3x3s2(torch.zeros((1, 2, 2, 9)))


def test_the_model_calls_the_ops(monkeypatch):
    calls = []
    for name in ("box3x3", "max3x3s2"):
        real = getattr(pool, name)
        monkeypatch.setattr(
            pool, name, lambda x, real=real, name=name: (
                calls.append(name), real(x))[1])
    x = torch.zeros((1, 8, 9, 9))
    assert torch.equal(iv3._avg_pool_same(x), pool.box3x3_reference(x))
    assert torch.equal(iv3._max_pool_v(x), pool.max3x3s2_reference(x))
    assert calls == ["box3x3", "max3x3s2"]


def _network_pools(shape):
    """[(kind, (C, H, W))] of every pool of InceptionV3 at an (H, W, C)
    pileup, in the order a forward runs them."""
    seen = []
    real_box, real_max = pool.box3x3, pool.max3x3s2

    def spy(kind, real):
        return lambda x: (seen.append((kind, tuple(x.shape[1:]))),
                          real(x))[1]
    iv3_pool = iv3.pool
    try:
        iv3_pool.box3x3 = spy("box", real_box)
        iv3_pool.max3x3s2 = spy("max", real_max)
        with torch.no_grad():
            iv3.InceptionV3(shape[2]).eval()(torch.zeros((1,) + shape))
    finally:
        iv3_pool.box3x3, iv3_pool.max3x3s2 = real_box, real_max
    return seen


@pytest.mark.parametrize("shape,boxes,maxes",
                         [((100, 221, 7), WGS_BOX, WGS_MAX),
                          ((100, 147, 10), PACBIO_BOX, PACBIO_MAX)])
def test_network_pool_shapes(shape, boxes, maxes):
    seen = _network_pools(shape)
    assert len(seen) == 13
    for kind, want in (("box", boxes), ("max", maxes)):
        got = [s for k, s in seen if k == kind]
        assert sorted(set(got)) == sorted(s for s, _ in want)
        assert all(got.count(s) == k for s, k in want)


def _train_pass(model, x):
    model.train()
    out = model.logits(x)
    out.sum().backward()


def test_spans_off_open_nothing(monkeypatch, recorder):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    torch.manual_seed(0)
    _train_pass(iv3.InceptionV3(3), torch.rand((2, 75, 75, 3)))
    assert opened == [] and trace.summary() == {}


def test_spans_on_count_thirteen_each_way(recorder):
    torch.manual_seed(0)
    model = iv3.InceptionV3(3)
    x = torch.rand((2, 75, 75, 3))
    with trace.recording():
        _train_pass(model, x)
    names = [r.name for r in trace.records()]
    assert names.count("pool.forward") == 13
    assert names.count("pool.backward") == 13
    backward = [r for r in trace.records() if r.name == "pool.backward"]
    assert all(r.events is None for r in backward)
    got = trace.summary()
    assert got["pool.forward"]["calls"] == 13
    assert got["pool.backward"]["calls"] == 13


# -- the kernels' logic, emulated on the CPU --

_LAUNCH = re.compile(
    r"(\w+<T, L>)<<<blocks, kThreads, 0, st>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("no host C++ compiler")
    with open(SOURCE) as f:
        source = f.read()
    source, launches = _LAUNCH.subn(
        lambda m: "emu_launch(dim3(blocks), dim3(kThreads), [&]() { "
        f"{m.group(1)}({m.group(2)}); }});", source)
    assert launches == 3
    build = tmp_path_factory.mktemp("pool_emulation")
    path = build / "pool.cpp"
    path.write_text(source)
    out = build / "libpool_emulation.so"
    subprocess.run(
        [compiler, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-w", "-I", os.path.join(REPO, "tests", "cuda_emulation",
                                  "threads"),
         "-o", str(out), str(path)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dv_box3x3_nhwc.argtypes = [i32, ptr, i64, ptr, i64] + [i32] * 3 + \
        [ptr]
    lib.dv_max3x3s2_forward_nhwc.argtypes = lib.dv_box3x3_nhwc.argtypes
    lib.dv_max3x3s2_backward_nhwc.argtypes = [i32, ptr, i64, ptr, i64, ptr,
                                              i64] + [i32] * 3 + [ptr]
    return lib


def emulated_box(lib, x):
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    assert lib.dv_box3x3_nhwc(pool._DTYPES[x.dtype], x.data_ptr(),
                              _row_stride(x), y.data_ptr(), n, c, h, w,
                              None) == 0
    return y


def emulated_max(lib, x, dy):
    n, c, h, w = x.shape
    y = torch.empty((n, c) + pooled(h, w), dtype=x.dtype,
                    memory_format=torch.channels_last)
    assert lib.dv_max3x3s2_forward_nhwc(
        pool._DTYPES[x.dtype], x.data_ptr(), _row_stride(x), y.data_ptr(),
        n, c, h, w, None) == 0
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    assert lib.dv_max3x3s2_backward_nhwc(
        pool._DTYPES[x.dtype], x.data_ptr(), _row_stride(x), dy.data_ptr(),
        _row_stride(dy), dx.data_ptr(), n, c, h, w, None) == 0
    return y, dx


EMULATED = [
    # (N, C, H, W), positions' stride (None: dense), values
    ((2, 8, 5, 7), None, "specials"),       # 16-byte path, odd H and W
    ((2, 5, 7, 9), None, "specials"),       # C not a multiple of 8
    ((1, 16, 1, 5), None, "ties"),          # a 1xN grid (box only)
    ((2, 24, 3, 3), 40, "specials"),        # one window; channel slices
    ((2, 12, 6, 8), 28, "ties"),            # even H and W: uncovered rows
    ((1, 3, 4, 11), None, "specials"),      # 3 channels, scalar path
    ((3, 16, 10, 25), None, "plain"),       # mixed0-2's grid
    ((2, 8, 21, 9), None, "ties"),          # two tiles down (box)
    ((1, 8, 37, 70), None, "ties"),         # tiles down and across
    ((1, 2048, 3, 5), None, "plain"),       # chunks of channel groups
    ((1, 520, 9, 7), 536, "specials"),      # the same, in a slice
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,ld,values", EMULATED,
                         ids=lambda v: str(v).replace(" ", ""))
def test_emulated_kernels_equal_torchs_cuda_rule(emulated, dtype, shape, ld,
                                                 values):
    n, c, h, w = shape
    x = seeded(shape, dtype, 7, ties=values == "ties",
               specials=values == "specials")
    xk = nhwc(x, ld)
    assert same_bits_but_nan_payloads(emulated_box(emulated, xk),
                                      box_cuda_rule(x))
    if h < 3 or w < 3:
        return
    dy = seeded((n, c) + pooled(h, w), dtype, 8,
                specials=values == "specials")
    y, dx = emulated_max(emulated, xk, nhwc(dy, ld))
    want_y, want_dx = max_cuda_rule(x, dy)
    assert same_bits(y, want_y)
    assert same_bits_but_nan_payloads(dx, want_dx)


def test_emulated_windows_of_minus_infinity(emulated):
    # Window (0, 0) of -inf only sends its gradient to (0, 0); any other
    # such window drops it, as torch's index 0 does on the card.
    x = torch.full((1, 8, 5, 5), -float("inf"))
    x[0, :, 4, 4] = 1.0
    dy = torch.arange(1.0, 1.0 + 8 * 4).view(1, 8, 2, 2)
    y, dx = emulated_max(emulated, nhwc(x), nhwc(dy))
    assert bool((y[:, :, :, :] == torch.tensor([[-float("inf"),
                                                 -float("inf")],
                                                [-float("inf"), 1.0]])).all())
    want = torch.zeros_like(x)
    want[0, :, 0, 0] = dy[0, :, 0, 0]
    want[0, :, 4, 4] = dy[0, :, 1, 1]
    assert same_bits(dx, want)
    _, want_dx = max_cuda_rule(x, dy)
    assert same_bits(dx, want_dx)


def test_emulated_kernels_repeat_bit_for_bit(emulated):
    x = nhwc(seeded((2, 16, 9, 11), torch.bfloat16, 9, ties=True))
    dy = nhwc(seeded((2, 16, 4, 5), torch.bfloat16, 10))
    runs = [(emulated_box(emulated, x),) + emulated_max(emulated, x, dy)
            for _ in range(2)]
    assert all(same_bits(a, b) for a, b in zip(*runs))


def test_emulated_entries_refuse_what_they_do_not_take(emulated):
    x = nhwc(torch.zeros((1, 8, 5, 5)))
    out = torch.empty(1024)
    p = x.data_ptr()
    assert emulated.dv_box3x3_nhwc(3, p, 8, out.data_ptr(), 1, 8, 5, 5,
                                   None) != 0
    assert emulated.dv_box3x3_nhwc(1, p, 4, out.data_ptr(), 1, 8, 5, 5,
                                   None) != 0
    assert emulated.dv_max3x3s2_forward_nhwc(1, p, 8, out.data_ptr(), 1, 8,
                                             2, 5, None) != 0
    assert emulated.dv_max3x3s2_backward_nhwc(1, p, 8, p, 4, out.data_ptr(),
                                              1, 8, 5, 5, None) != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("values", ["ties", "plain"])
def test_cuda_rule_agrees_with_torch_on_the_cpu(dtype, values):
    # Where torch's CPU kernels compute what its CUDA kernels do (finite
    # values, no negative zero in dy), the stated rule equals them.
    x = seeded((2, 8, 9, 11), dtype, 11, ties=values == "ties")
    dy = seeded((2, 8, 4, 5), dtype, 12)
    xr = nhwc(x).requires_grad_(True)
    y = F.max_pool2d(xr, 3, stride=2)
    dx, = torch.autograd.grad(y, xr, dy)
    box, want_y, want_dx = torch_cuda_rule(x, dy)
    assert same_bits(F.avg_pool2d(nhwc(x), 3, 1, 1), box)
    assert same_bits(y.detach(), want_y)
    assert same_bits(dx, want_dx)


# -- the card --


def _torch_pools(x, dy_box, dy_max):
    """torch's own CUDA pools, as the model ran them before the kernels:
    the box filter's forward and its backward (the pool of dy), the max
    pool's forward and autograd backward."""
    xr = x.detach().requires_grad_(True)
    y = F.max_pool2d(xr, 3, stride=2)
    dx, = torch.autograd.grad(y, xr, dy_max)
    return (F.avg_pool2d(x, 3, 1, 1), F.avg_pool2d(dy_box, 3, 1, 1),
            y.detach(), dx)


def _kernel_pools(x, dy_box, dy_max):
    y = pool.max3x3s2_forward_kernel(x)
    return (pool.box3x3_kernel(x), pool.box3x3_kernel(dy_box), y,
            pool.max3x3s2_backward_kernel(dy_max, x))


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("preset", ["wgs", "pacbio"])
def test_kernels_equal_torch_at_the_network_shapes(card, dtype, preset):
    shapes = {"wgs": WGS_BOX + WGS_MAX, "pacbio": PACBIO_BOX + PACBIO_MAX}
    for i, ((c, h, w), _) in enumerate(shapes[preset]):
        x = nhwc(seeded((16, c, h, w), dtype, 20 + i, card))
        dy_box = nhwc(seeded((16, c, h, w), dtype, 40 + i, card))
        dy_max = nhwc(seeded((16, c) + pooled(h, w), dtype, 60 + i, card)) \
            if h >= 3 else None
        got = [pool.box3x3_kernel(x), pool.box3x3_kernel(dy_box)]
        want = [F.avg_pool2d(x, 3, 1, 1), F.avg_pool2d(dy_box, 3, 1, 1)]
        if dy_max is not None:
            got += [pool.max3x3s2_forward_kernel(x),
                    pool.max3x3s2_backward_kernel(dy_max, x)]
            want += list(_torch_pools(x, dy_box, dy_max)[2:])
        for a, b in zip(got, want):
            assert same_bits(a, b), (preset, c, h, w)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_equal_torch_on_ties_nans_and_slices(card, dtype):
    for shape, ld, values in ((2, 8, 21, 9), 24, "ties"), \
            ((2, 16, 10, 25), None, "specials"), \
            ((3, 5, 7, 9), None, "specials"), \
            ((2, 24, 3, 3), 40, "specials"):
        x = nhwc(seeded(shape, dtype, 70, card, ties=values == "ties",
                        specials=values == "specials"), ld)
        dy_box = nhwc(seeded(shape, dtype, 71, card), ld)
        dy_max = nhwc(seeded(shape[:2] + pooled(*shape[2:]), dtype, 72,
                             card, specials=values == "specials"), ld)
        # float64 sums keep a NaN operand's sign and payload, and where
        # two NaNs meet (inf - inf, then a NaN tap) which one the add
        # passes on depends on the operand order the compiler chose, in
        # torch's kernel as in this one: float64 NaNs are held as NaNs.
        same = same_bits_but_nan_payloads if dtype == torch.float64 \
            else same_bits
        for a, b in zip(_kernel_pools(x, dy_box, dy_max),
                        _torch_pools(x, dy_box, dy_max)):
            assert same(a, b), (shape, ld, values)


@pytest.mark.chip
def test_two_runs_are_bit_equal(card):
    x = nhwc(seeded((64, 192, 21, 51), torch.bfloat16, 80, card))
    dy = nhwc(seeded((64, 192, 10, 25), torch.bfloat16, 81, card))
    runs = [_kernel_pools(x, x, dy) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(*runs))


@pytest.mark.chip
def test_thirteen_launches_each_way(card):
    torch.manual_seed(0)
    model = iv3.InceptionV3(7).to(card).train()
    model.dtype = torch.bfloat16
    x = torch.rand((2, 100, 221, 7), device=card)
    before = (pool.box3x3.launches, pool.max3x3s2.launches)
    out = model.logits(x)
    assert (pool.box3x3.launches - before[0],
            pool.max3x3s2.launches - before[1]) == (9, 4)
    out.sum().backward()
    assert (pool.box3x3.launches - before[0],
            pool.max3x3s2.launches - before[1]) == (18, 8)


@pytest.mark.chip
def test_events_with_spans_off_and_on(card, monkeypatch, recorder):
    torch.manual_seed(0)
    model = iv3.InceptionV3(7).to(card)
    model.dtype = torch.bfloat16
    x = torch.rand((2, 100, 221, 7), device=card)
    made = []
    real = torch.cuda.Event

    def counting(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", counting)
    _train_pass(model, x)
    assert made == []
    with trace.recording():
        _train_pass(model, x)
    torch.cuda.synchronize()
    assert len(made) == 2 * 26
    got = trace.summary()
    assert got["pool.forward"]["calls"] == 13
    assert got["pool.backward"]["calls"] == 13
    assert got["pool.backward"]["device_ms"] > 0


@pytest.mark.chip
def test_gradcheck_float64_on_the_card(card):
    x = seeded((2, 8, 7, 9), torch.float64, 90, card).requires_grad_(True)
    for op in (pool.box3x3, pool.max3x3s2):
        assert torch.autograd.gradcheck(op, (x,))


@pytest.mark.chip
def test_refusals(card):
    x = seeded((2, 16, 7, 9), torch.float32, 91, card)
    with pytest.raises(TypeError):
        pool.box3x3(x.half())
    with pytest.raises(TypeError):
        pool.max3x3s2(x.half())
    # The kernels' entries refuse another layout; the ops make x
    # channels_last first.
    with pytest.raises(ValueError, match="channels_last"):
        pool.box3x3_kernel(x.contiguous())
    with pytest.raises(ValueError, match="channels_last"):
        pool.max3x3s2_forward_kernel(x.contiguous())
    with pytest.raises(ValueError):
        pool.max3x3s2(nhwc(x)[:, :, :2])
    assert same_bits(pool.box3x3(x.contiguous()), pool.box3x3(nhwc(x)))
    assert same_bits(pool.max3x3s2(x.contiguous()), pool.max3x3s2(nhwc(x)))

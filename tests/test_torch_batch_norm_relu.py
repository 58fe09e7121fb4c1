"""The fused training-mode batch norm + ReLU (`ops/batch_norm_relu.py`,
`csrc/batch_norm_relu.cu`).

On the CPU: the model's ConvBN takes the plain version, which is the
code the layer ran before the kernels, bit for bit, and launches
nothing; the counters `batch_norm.fused` / `batch_norm.plain` count each
training-mode batch norm + ReLU on one device while spans are on, and
eval mode, the data-parallel path and the batch norm without its ReLU
count neither; the host's launch geometry covers the
network's shapes; the wrapper's checks refuse what the kernels do not
take. The kernels' logic runs here too: the CUDA source is compiled with
the host C++ compiler against `tests/cuda_emulation/threads/
cuda_runtime.h` (a thread per CUDA thread, a barrier per
__syncthreads) and held to the plain version, at geometries the card's
run does not visit (several chunks, a short last chunk, narrow tiles,
dy a channel slice).

Tests marked `chip` need a CUDA card and skip without one; they decide
inside the `card` fixture. On the card they hold the kernels to the
plain version at the network's own channel counts and spatial sizes, in
bfloat16, float32 and float64, run `gradcheck` in float64, and check
repeat runs, launch counts and refusals:
`python -m pytest --noconftest tests/test_torch_batch_norm_relu.py -q`
(this file imports no JAX; `--noconftest` skips the JAX set-up of
`tests/conftest.py`)."""

import ctypes
import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.ops import batch_norm_relu as bnr
from deepvariant_tpu_torch.utils import trace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "deepvariant_tpu_torch", "csrc",
                      "batch_norm_relu.cu")
EPS = iv3.BN_EPSILON
DTYPES = (torch.bfloat16, torch.float32, torch.float64)

# The (C, H, W) after every ConvBN of InceptionV3 at 100x221x7 (WGS) and
# 100x147x10 (PacBio), largest first; test_network_shapes checks them.
WGS_SHAPES = [(64, 47, 108), (192, 21, 51), (32, 49, 110), (32, 47, 108),
              (80, 23, 53), (96, 10, 25), (384, 4, 12), (64, 10, 25),
              (48, 10, 25), (192, 4, 12), (32, 10, 25), (160, 4, 12),
              (128, 4, 12), (96, 4, 12), (448, 1, 5), (384, 1, 5),
              (320, 1, 5), (192, 1, 5)]
PACBIO_SHAPES = [(64, 47, 71), (192, 21, 33), (32, 49, 73), (32, 47, 71),
                 (80, 23, 35), (96, 10, 16), (384, 4, 7), (64, 10, 16),
                 (48, 10, 16), (192, 4, 7), (32, 10, 16), (160, 4, 7),
                 (128, 4, 7), (96, 4, 7), (448, 1, 3), (384, 1, 3),
                 (320, 1, 3), (192, 1, 3)]


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


def activations(shape, dtype, seed, device="cpu"):
    """A seeded channels_last (N, C, H, W) activation: per-channel
    offsets and scales, as a conv's output has."""
    n, c, h, w = shape
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, h, w, c)) * rng.uniform(0.3, 3.0, c) \
        + rng.uniform(-2.0, 2.0, c)
    return torch.from_numpy(x).to(device=device, dtype=dtype).permute(
        0, 3, 1, 2)


def layer_params(c, dtype, seed, device="cpu"):
    rng = np.random.RandomState(seed + 1)
    acc = torch.promote_types(dtype, torch.float32)

    def t(a):
        return torch.from_numpy(a).to(device=device, dtype=acc)
    return (t(rng.uniform(-0.5, 0.5, c)), t(rng.standard_normal(c)),
            t(rng.uniform(0.5, 2.0, c)))


def todays_batch_norm_relu(x, bias, running_mean, running_var, momentum):
    """The layer as `BatchNorm.forward` + `F.relu` of
    models/inception_v3.py computed it before the kernels."""
    with torch.no_grad():
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min(
            xf.square().mean(dim=(0, 2, 3)) - mean.square(), 0.0)
        del xf
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
    y = torch.batch_norm(x, torch.ones_like(bias), bias, None, None, True,
                         0.0, EPS, torch.backends.cudnn.enabled)
    return F.relu(y)


# -- the CPU: the plain path, the counters, the geometry, the checks --


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32, 10, 25), (3, 48, 4, 12),
                                   (2, 16, 1, 5)])
def test_plain_path_is_todays_code_bit_for_bit(dtype, shape):
    n, c, h, w = shape
    torch.manual_seed(11)
    layer = iv3.ConvBN(8, c, (3, 3)).to(dtype).train()
    layer.bn.momentum = 0.9
    with torch.no_grad():
        layer.bn.bias.normal_()
        layer.bn.mean.normal_()
        layer.bn.var.uniform_(0.5, 2.0)
    x0 = activations((n, 8, h, w), dtype, 3)
    before = bnr.batch_norm_relu.launches

    x = x0.clone().requires_grad_(True)
    y = layer(x)
    y.backward(activations(tuple(y.shape), dtype, 5))
    got = [y.detach(), layer.bn.mean.clone(), layer.bn.var.clone(),
           x.grad, layer.conv.weight.grad, layer.bn.bias.grad]

    torch.manual_seed(11)
    twin = iv3.ConvBN(8, c, (3, 3)).to(dtype).train()
    with torch.no_grad():
        twin.bn.bias.normal_()
        twin.bn.mean.normal_()
        twin.bn.var.uniform_(0.5, 2.0)
    x = x0.clone().requires_grad_(True)
    conv = twin.conv
    z = conv._conv_forward(x, conv.weight.to(dtype), None)
    y = todays_batch_norm_relu(z, twin.bn.bias, twin.bn.mean, twin.bn.var,
                               0.9)
    y.backward(activations(tuple(y.shape), dtype, 5))
    want = [y.detach(), twin.bn.mean, twin.bn.var, x.grad,
            twin.conv.weight.grad, twin.bn.bias.grad]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bnr.batch_norm_relu.launches == before


def test_standalone_training_batch_norm_is_todays_code():
    torch.manual_seed(2)
    bn = iv3.BatchNorm(16, 0.9).train()
    with torch.no_grad():
        bn.bias.normal_()
    x = activations((3, 16, 4, 5), torch.float32, 7)
    got = bn(x)
    rm, rv = torch.zeros(16), torch.ones(16)
    want = todays_batch_norm_relu(x, bn.bias, rm, rv, 0.9)
    assert torch.equal(F.relu(got), want)
    assert torch.equal(bn.mean, rm) and torch.equal(bn.var, rv)


def test_counters_name_the_path_while_recording(recorder):
    layer = iv3.ConvBN(8, 16, (1, 1)).train()
    x = activations((2, 8, 3, 4), torch.float32, 1)
    layer(x)
    assert trace.counts() == {}
    with trace.recording():
        layer(x)
        layer(x)
        layer.bn(layer.conv(x), relu=True)
        layer.bn(layer.conv(x))
    assert trace.counts() == {"batch_norm.plain": 3}
    layer.eval()
    with trace.recording():
        layer(x)
    with iv3.sync_batch_norm(layer, lambda t: t[None]):
        layer.train()
        with trace.recording():
            layer(x)
    assert trace.counts() == {"batch_norm.plain": 3}


def test_synced_path_and_eval_mode_keep_their_code():
    torch.manual_seed(3)
    layer = iv3.ConvBN(8, 16, (1, 1)).train()
    x = activations((2, 8, 3, 4), torch.float64, 2)
    layer.double()
    with iv3.sync_batch_norm(layer, lambda t: t[None]):
        synced = layer(x)
        z = layer.conv(x)
        assert torch.equal(synced, F.relu(layer.bn._forward_synced(z)))
    layer.eval()
    want = F.relu(F.batch_norm(z, layer.bn.mean, layer.bn.var, None,
                               layer.bn.bias, False, 0.0, EPS))
    assert torch.equal(layer(x), want)


def test_trace_counts_only_while_on_and_reset_clears(recorder):
    trace.count("a")
    assert trace.counts() == {}
    with trace.recording():
        trace.count("a")
        trace.count("a", 4)
        trace.count("b", 2)
    trace.count("b")
    assert trace.counts() == {"a": 5, "b": 2}
    trace.reset()
    assert trace.counts() == {}
    with trace.recording():
        trace.count("c")
    assert recorder.counts() == {"c": 1}


def test_network_shapes():
    for shape, want in (((100, 221, 7), WGS_SHAPES),
                        ((100, 147, 10), PACBIO_SHAPES)):
        model = iv3.InceptionV3(shape[2]).eval()
        seen = []
        for m in model.modules():
            if isinstance(m, iv3.ConvBN):
                m.register_forward_hook(
                    lambda mod, inp, out: seen.append(tuple(out.shape[1:])))
        with torch.no_grad():
            model(torch.zeros((1,) + shape))
        assert len(seen) == 94
        assert sorted(set(seen)) == sorted(want)


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("batch", [1, 4, 2048])
def test_geometry_covers_the_network(itemsize, batch):
    for c, h, w in WGS_SHAPES + PACBIO_SHAPES:
        rows = batch * h * w
        g = bnr.geometry(rows, c, itemsize, 132)
        cols = c * itemsize // 16
        assert g.tiles * g.vc >= cols > (g.tiles - 1) * g.vc
        assert g.vc <= bnr.MAX_COLUMNS and g.vc * g.ty <= bnr.THREADS
        assert g.ty >= 16 // itemsize
        assert g.chunks * g.rows_per_chunk >= rows
        assert (g.chunks - 1) * g.rows_per_chunk < rows
        assert g.chunks <= max(1, math.isqrt(rows // bnr.MERGE_ROWS))
        assert g.chunks * g.tiles <= 2 * 132 + g.tiles


def test_geometry_fills_the_card_at_the_largest_layers():
    # The stem's layers at batch 2,048: 10-11 M rows of 32-64 channels.
    for c, h, w in WGS_SHAPES[:4]:
        g = bnr.geometry(2048 * h * w, c, 2, 132)
        assert g.chunks * g.tiles >= 2 * 132


def test_checks_refuse_what_the_kernels_do_not_take():
    bias, rm, rv = layer_params(16, torch.float32, 0)
    x = activations((2, 16, 3, 4), torch.float32, 0)
    assert bnr._check(x, bias, rm, rv) == torch.float32
    with pytest.raises(TypeError):
        bnr._check(x.half(), bias, rm, rv)
    with pytest.raises(ValueError, match="multiple of 8"):
        b12, m12, v12 = layer_params(12, torch.float32, 0)
        bnr._check(activations((2, 12, 3, 4), torch.float32, 0), b12, m12,
                   v12)
    with pytest.raises(ValueError, match="channels_last"):
        bnr._check(x.contiguous(), bias, rm, rv)
    with pytest.raises(ValueError, match="bias"):
        bnr._check(x.double(), bias, rm, rv)


def test_row_stride_of_channel_slices():
    wide = activations((2, 40, 3, 4), torch.float32, 0)
    assert bnr._row_stride(wide) == 40
    assert bnr._row_stride(wide[:, 8:24]) == 40
    assert bnr._row_stride(wide.contiguous()[:, 8:24]) is None
    assert bnr._row_stride(activations((2, 40, 1, 1), torch.float32, 0)) \
        == 40


# -- the kernels' logic, emulated on the CPU --

_LAUNCH = re.compile(
    r"(bn_\w+<T>)<<<grid, g\.vc \* g\.ty, 0, s>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("no host C++ compiler")
    with open(SOURCE) as f:
        source = f.read()
    source, launches = _LAUNCH.subn(
        lambda m: "emu_launch(grid, dim3(g.vc * g.ty), [&]() { "
        f"{m.group(1)}({m.group(2)}); }});", source)
    assert launches == 4
    build = tmp_path_factory.mktemp("batch_norm_relu_emulation")
    path = build / "batch_norm_relu.cpp"
    path.write_text(source)
    out = build / "libbatch_norm_relu_emulation.so"
    subprocess.run(
        [compiler, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         "-w", "-I", os.path.join(REPO, "tests", "cuda_emulation",
                                  "threads"),
         "-o", str(out), str(path)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_double)
    lib.dv_batch_norm_relu_forward.argtypes = [i32] + [ptr] * 8 + [i64] + \
        [i32] * 6 + [f64] * 3 + [ptr]
    lib.dv_batch_norm_relu_backward.argtypes = [i32, ptr, ptr, i64] + \
        [ptr] * 6 + [i64] + [i32] * 6 + [ptr]
    return lib


def emulated_forward(lib, x, bias, rm, rv, momentum, g):
    c = x.shape[1]
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean, rstd = torch.empty_like(bias), torch.empty_like(bias)
    part = torch.empty(3 * g.chunks * c, dtype=bias.dtype)
    err = lib.dv_batch_norm_relu_forward(
        bnr._DTYPES[x.dtype], x.data_ptr(), y.data_ptr(), bias.data_ptr(),
        rm.data_ptr(), rv.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        part.data_ptr(), g.rows, c, g.rows_per_chunk, g.chunks, g.tiles,
        g.vc, g.ty, momentum, 1 - momentum, EPS, None)
    assert err == 0
    return y, mean, rstd


def emulated_backward(lib, dy, ld, x, bias, mean, rstd, g):
    c = x.shape[1]
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dbias = torch.empty_like(bias)
    part = torch.empty(2 * g.chunks * c, dtype=bias.dtype)
    err = lib.dv_batch_norm_relu_backward(
        bnr._DTYPES[x.dtype], x.data_ptr(), dy.data_ptr(), ld, dx.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), bias.data_ptr(), part.data_ptr(),
        dbias.data_ptr(), g.rows, c, g.rows_per_chunk, g.chunks, g.tiles,
        g.vc, g.ty, None)
    assert err == 0
    return dx, dbias


# Tolerances against the plain version. Both take the statistics in the
# accumulator type in different orders, and the plain version's
# torch.batch_norm rounds its own way, so outputs differ by a few units
# of the accumulator's last place, and bfloat16 outputs by one bfloat16
# step where the float32 value sits at a rounding boundary. dx is held
# relative to its own norm.
TOL = {torch.float64: dict(stat=1e-12, y=1e-12, dx=1e-10),
       torch.float32: dict(stat=1e-6, y=1e-5, dx=1e-5),
       torch.bfloat16: dict(stat=1e-6, y=8e-3, dx=8e-3)}
# A pre-activation (x - mean) * rstd + bias within rounding of 0 may fall
# on either side of the ReLU's gate in the two versions (their statistics
# differ in the last place). The backward of the plain version is
# therefore taken with the kernels' gate (their y > 0), and where the
# gates differ, the float64 pre-activation must lie within this of 0.
GATE = {torch.float64: 1e-9, torch.float32: 1e-4, torch.bfloat16: 1e-4}


def compare_to_plain(shape, dtype, seed, run_forward, run_backward,
                     momentum=0.9, dy_slice=False, device="cpu"):
    """Runs the kernels (through `run_forward`/`run_backward`, on tensors
    made on `device`) and the plain version on the CPU on the same seeded
    inputs and asserts they agree."""
    n, c, h, w = shape
    tol = TOL[dtype]
    x = activations(shape, dtype, seed, device)
    bias, rm, rv = layer_params(c, dtype, seed, device)
    if dy_slice:
        wide = activations((n, c + 16, h, w), dtype, seed + 2, device)
        dy = wide[:, 8:8 + c]
    else:
        dy = activations(shape, dtype, seed + 2, device)
    rm_k, rv_k = rm.clone(), rv.clone()
    y, mean, rstd = run_forward(x, bias, rm_k, rv_k, momentum)
    dx, dbias = run_backward(dy, x, bias, mean, rstd)

    cpu = [t.detach().cpu() for t in (x, bias, rm, rv, dy, y)]
    x64 = cpu[0].double()
    want_mean = x64.mean(dim=(0, 2, 3))
    want_rstd = 1 / torch.sqrt(x64.var(dim=(0, 2, 3), unbiased=False) + EPS)
    xr = cpu[0].clone().requires_grad_(True)
    br = cpu[1].clone().requires_grad_(True)
    rm_p, rv_p = cpu[2].clone(), cpu[3].clone()
    zp = bnr.batch_norm_train_reference(xr, br, rm_p, rv_p, momentum, EPS)
    yp = F.relu(zp)
    gate = cpu[5] > 0
    dxp, dbp = torch.autograd.grad(zp, (xr, br), cpu[4] * gate)

    def close(a, b, rel):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= rel * scale

    def per_channel(t):
        return t.view(1, c, 1, 1)

    close(mean, want_mean, tol["stat"])
    close(rstd, want_rstd, tol["stat"])
    close(rm_k, rm_p, tol["stat"])
    close(rv_k, rv_p, tol["stat"])
    assert y.dtype == dtype and dx.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last)
    close(y, yp, tol["y"])
    pre = (x64 - per_channel(want_mean)) * per_channel(want_rstd) + \
        per_channel(cpu[1].double())
    differ = gate != (yp > 0)
    assert float(differ.double().mean()) < 1e-3
    assert bool((pre[differ].abs() <= GATE[dtype]).all())
    dxp = dxp.double()
    d = (dx.detach().cpu().double() - dxp).norm()
    assert float(d) <= tol["dx"] * float(dxp.norm())
    close(dbias, dbp, tol["dx"])
    return y, dx


def fixed_geometry(rows, c, itemsize, rows_per_chunk, vc, ty):
    cols = c * itemsize // 16
    tiles = -(-cols // vc)
    return bnr.Geometry(rows, c, rows_per_chunk, -(-rows // rows_per_chunk),
                        tiles, vc, ty)


EMULATED = [
    # (shape, dtype, geometry: None = the host's, else (rows a chunk, vc,
    # ty)), dy a channel slice
    ((3, 32, 10, 25), torch.bfloat16, None, False),
    ((2, 448, 1, 5), torch.bfloat16, None, True),
    ((2, 192, 4, 12), torch.float32, None, True),
    ((2, 320, 1, 5), torch.float64, None, False),
    ((4, 64, 5, 7), torch.bfloat16, (37, 8, 8), True),
    ((4, 64, 5, 7), torch.float32, (23, 6, 9), False),
    ((3, 48, 4, 6), torch.float64, (11, 5, 3), True),
    ((1, 16, 1, 1), torch.float32, None, False),
]


@pytest.mark.parametrize("shape,dtype,geo,dy_slice", EMULATED,
                         ids=lambda v: str(v).replace(" ", ""))
def test_emulated_kernels_equal_plain_version(emulated, shape, dtype, geo,
                                              dy_slice):
    n, c, h, w = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    if geo is None:
        g = bnr.geometry(n * h * w, c, itemsize, 132)
    else:
        g = fixed_geometry(n * h * w, c, itemsize, *geo)

    def run_backward(dy, x, bias, mean, rstd):
        return emulated_backward(emulated, dy, bnr._row_stride(dy), x, bias,
                                 mean, rstd, g)

    compare_to_plain(
        shape, dtype, 5,
        lambda x, b, rm, rv, m: emulated_forward(emulated, x, b, rm, rv, m,
                                                 g),
        run_backward, dy_slice=dy_slice)


def test_emulated_kernels_repeat_bit_for_bit(emulated):
    shape, dtype = (4, 64, 5, 7), torch.bfloat16
    g = fixed_geometry(140, 64, 2, 37, 8, 8)
    x = activations(shape, dtype, 9)
    dy = activations(shape, dtype, 10)
    runs = []
    for _ in range(2):
        bias, rm, rv = layer_params(64, dtype, 9)
        y, mean, rstd = emulated_forward(emulated, x, bias, rm, rv, 0.9, g)
        dx, dbias = emulated_backward(emulated, dy, 64, x, bias, mean, rstd,
                                      g)
        runs.append((y, mean, rstd, rm, rv, dx, dbias))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_emulated_geometry_is_checked(emulated):
    x = activations((2, 16, 2, 2), torch.float32, 0)
    bias, rm, rv = layer_params(16, torch.float32, 0)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty(64)
    # Chunks that miss rows, then a tile wider than the block's threads.
    for rows_per_chunk, chunks, tiles, vc, ty in ((2, 2, 1, 4, 8),
                                                  (8, 1, 1, 4, 200)):
        err = emulated.dv_batch_norm_relu_forward(
            1, x.data_ptr(), out.data_ptr(), bias.data_ptr(), rm.data_ptr(),
            rv.data_ptr(), part.data_ptr(), part.data_ptr(), part.data_ptr(),
            8, 16, rows_per_chunk, chunks, tiles, vc, ty, 0.9, 0.1, EPS,
            None)
        assert err != 0


# -- the card --


def card_forward(x, bias, rm, rv, momentum):
    return bnr.forward_kernel(x, bias, rm, rv, momentum, EPS)


def card_backward(dy, x, bias, mean, rstd):
    return bnr.backward_kernel(dy, x, bias, mean, rstd)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,shapes", [(4, WGS_SHAPES),
                                          (32, PACBIO_SHAPES[4:]),
                                          (8, PACBIO_SHAPES[:4])])
def test_kernels_equal_plain_version_at_the_network_shapes(card, dtype,
                                                           batch, shapes):
    for i, (c, h, w) in enumerate(shapes):
        compare_to_plain((batch, c, h, w), dtype, 100 + i, card_forward,
                         card_backward, dy_slice=i % 2 == 1, device=card)


@pytest.mark.chip
def test_gradcheck_float64(card):
    x = activations((3, 16, 4, 5), torch.float64, 21, card)
    x = x.detach().requires_grad_(True)
    bias, rm, rv = layer_params(16, torch.float64, 21, card)
    bias.requires_grad_(True)

    def fn(x, bias):
        return bnr.batch_norm_relu(x.contiguous(
            memory_format=torch.channels_last), bias, rm.clone(), rv.clone(),
            0.9, EPS)
    assert torch.autograd.gradcheck(fn, (x, bias), eps=1e-6, atol=1e-6)


@pytest.mark.chip
def test_two_runs_are_bit_equal(card):
    x = activations((32, 192, 21, 33), torch.bfloat16, 31, card)
    dy = activations((32, 192, 21, 33), torch.bfloat16, 32, card)
    runs = []
    for _ in range(2):
        bias, rm, rv = layer_params(192, torch.bfloat16, 31, card)
        y, mean, rstd = card_forward(x, bias, rm, rv, 0.9997)
        dx, dbias = card_backward(dy, x, bias, mean, rstd)
        runs.append((y, mean, rstd, rm, rv, dx, dbias))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.chip
def test_launches_two_forward_two_backward_a_layer(card):
    torch.manual_seed(0)
    model = iv3.InceptionV3(7).to(card).train()
    x = torch.rand((2, 100, 221, 7), device=card).to(torch.bfloat16)
    model.dtype = torch.bfloat16
    before = bnr.batch_norm_relu.launches
    out = model(x)
    assert bnr.batch_norm_relu.launches - before == 2 * 94
    out.sum().backward()
    assert bnr.batch_norm_relu.launches - before == 4 * 94


@pytest.mark.chip
def test_wrapper_raises_on_what_the_kernels_do_not_take(card):
    bias, rm, rv = layer_params(16, torch.float32, 0, card)
    x = activations((2, 16, 3, 4), torch.float32, 0, card)
    with pytest.raises(TypeError):
        bnr.batch_norm_relu(x.half(), bias, rm, rv, 0.9, EPS)
    b12, m12, v12 = layer_params(12, torch.float32, 0, card)
    with pytest.raises(ValueError):
        bnr.batch_norm_relu(activations((2, 12, 3, 4), torch.float32, 0,
                                        card), b12, m12, v12, 0.9, EPS)
    # The kernels' entry refuses another layout; the op makes x
    # channels_last first (CUDA's float64 convolutions return another).
    with pytest.raises(ValueError):
        bnr.forward_kernel(x.contiguous(), bias, rm, rv, 0.9, EPS)
    got = bnr.batch_norm_relu(x.contiguous(), bias, rm.clone(), rv.clone(),
                              0.9, EPS)
    want = bnr.batch_norm_relu(x, bias, rm.clone(), rv.clone(), 0.9, EPS)
    assert torch.equal(got, want)

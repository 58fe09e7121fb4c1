"""The CUDA paint kernel's logic, run on the CPU.

`deepvariant_tpu_torch/csrc/pileup_paint.cu` is compiled with the host
C++ compiler against `tests/cuda_emulation/cuda_runtime.h`, which runs
the kernel body thread by thread and barrier phase by barrier phase, and
its two entry points are called through ctypes on numpy-backed tensors
and held bit-exact against the plain PyTorch versions. This checks the
kernel's index math, masks, packing and tails at shapes the card's run
does not visit; that it compiles with nvcc, and its speed, only
chip_smoke.py on the card can show."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from deepvariant_tpu_torch.make_examples import pileup
from deepvariant_tpu_torch.make_examples.pileup_device import (
    ALT_KEYS,
    DEVICE_CHANNELS,
    PLAN_KEYS,
    plan_colors,
)
from deepvariant_tpu_torch.ops import pileup_paint as pp
from torch_port_util import (
    ODD_COLORS,
    edge_hp,
    edge_plans,
    random_plans,
    with_alt,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "deepvariant_tpu_torch", "csrc",
                      "pileup_paint.cu")
_LAUNCH = re.compile(
    r"paint_kernel<Form><<<blocks, kThreads, row_bytes,\s*"
    r"static_cast<cudaStream_t>\(stream\)>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("no host C++ compiler")
    with open(SOURCE) as f:
        source = f.read()
    source = source.replace("#include <cuda_runtime.h>",
                            '#include "cuda_runtime.h"')
    source = source.replace(
        "extern __shared__ RowInfo row_table[];",
        "RowInfo* row_table = reinterpret_cast<RowInfo*>("
        "emu_dynamic_shared);")
    source, launches = _LAUNCH.subn(
        lambda m: "emu_launch(blocks, kThreads, 2, [&]() { "
        f"paint_kernel<Form>({m.group(1)}); }});", source)
    assert launches == 1 and source.count("__syncthreads();") == 2
    build = tmp_path_factory.mktemp("paint_emulation")
    path = build / "pileup_paint.cpp"
    path.write_text(source)
    out = build / "libpileup_paint_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
         "-I", os.path.join(REPO, "tests", "cuda_emulation"),
         "-o", str(out), str(path)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.dv_pileup_paint.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.dv_pileup_paint.restype = ctypes.c_int
    lib.dv_pileup_paint_plan.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.POINTER(pp._PlanColorsC), ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.dv_pileup_paint_plan.restype = ctypes.c_int
    return lib


def emulated_plan(lib, tensors, colors):
    n, rows, width = tensors[0].shape
    out = torch.empty((n, colors.band + rows, width, colors.planes),
                      dtype=torch.uint8)
    pointers = [t.data_ptr() if t is not None else None for t in tensors]
    err = lib.dv_pileup_paint_plan(*pointers, pp.plan_colors_struct(colors),
                                   out.data_ptr(), n, rows, width, None)
    return err, out


def _cases():
    """Seeded channel lists of every length at widths from 1 column up,
    bands from 0, with and without diff mode and the odd colors; then the
    presets' shapes."""
    rng = np.random.RandomState(0)
    channels = sorted(DEVICE_CHANNELS)
    cases = []
    for trial in range(24):
        k = trial % 10 + 1
        band = int(rng.randint(0, 6))
        cases.append(dict(
            channels=tuple(rng.choice(channels, k, replace=trial % 3 == 0)
                           .tolist()),
            alt_aligned_pileup="diff_channels" if trial % 2 == 0 else "none",
            width=int(rng.choice([1, 2, 7, 33, 100, 147])),
            height=band + int(rng.randint(1, 30)),
            reference_band_height=band,
            **(ODD_COLORS if trial % 4 == 1 else {})))
    cases.append(dict(channels=(1, 2, 3, 4, 5, 6, 7, 26),
                      alt_aligned_pileup="diff_channels", width=147))
    cases.append(dict(channels=tuple(channels),
                      alt_aligned_pileup="diff_channels", width=147))
    cases.append(dict())
    cases.append(dict(channels=(1, 2, 3, 4, 5, 6)))
    return cases


@pytest.mark.parametrize("kw", _cases(), ids=lambda kw: "-".join(
    [str(len(kw.get("channels", ())) or 7) + "ch",
     "w" + str(kw.get("width", 221)), "h" + str(kw.get("height", 100)),
     "b" + str(kw.get("reference_band_height", 5)),
     kw.get("alt_aligned_pileup", "none")[:4],
     "odd" if "base_color_stride" in kw else "std"]))
def test_emulated_plan_form_equals_plain_version(library, kw):
    options = pileup.PileupOptions(**kw)
    colors = plan_colors(options,
                         options.alt_aligned_pileup == "diff_channels")
    n = 7 if options.width < 100 else 3
    plans = with_alt(edge_hp(edge_plans(random_plans(
        n, len(options.channels), rows=options.max_reads,
        width=options.width))), 1)
    tensors = [torch.from_numpy(plans[k]) for k in PLAN_KEYS + ALT_KEYS]
    if not colors.diff:
        tensors[len(PLAN_KEYS):] = [None] * 4
    err, out = emulated_plan(library, tensors, colors)
    assert err == 0
    want = pp.paint_pileup_plan_reference(*tensors, colors)
    assert out.shape == want.shape
    assert torch.equal(out, want)


@pytest.mark.parametrize("n,rows,width", [(3, 95, 221), (2, 16, 32),
                                          (5, 7, 1), (1, 1, 2049)])
def test_emulated_rows_form_equals_plain_version(library, n, rows, width):
    plans = edge_plans(random_plans(n, 3, rows=rows, width=width))
    args = [a.contiguous() for a in pp.rows_form_args(
        *[torch.from_numpy(plans[k]) for k in (
            "bases", "quals", "mapq", "rev", "tlen", "support", "row_valid",
            "ref_window")], plan_colors(pileup.PileupOptions()))]
    out = torch.empty((n, rows, width, pp.NUM_CHANNELS), dtype=torch.uint8)
    err = library.dv_pileup_paint(*[a.data_ptr() for a in args],
                                  out.data_ptr(), n, rows, width, None)
    assert err == 0
    assert torch.equal(out, pp.paint_pileup_reference(*args))


def test_emulated_entry_points_refuse_what_the_kernel_does_not_take(library):
    plans = with_alt(random_plans(2, 4, rows=4, width=5), 5)
    tensors = [torch.from_numpy(plans[k]) for k in PLAN_KEYS + ALT_KEYS]
    colors = plan_colors(pileup.PileupOptions(
        width=5, height=9, alt_aligned_pileup="diff_channels"), True)
    assert emulated_plan(library, tensors, colors)[0] == 0
    # Diff mode without the alt tensors.
    assert emulated_plan(library, tensors[:11] + [None] * 4, colors)[0] != 0
    # More planes than the kernel has instantiations for.
    struct = pp.plan_colors_struct(colors)
    struct.planes = 13
    out = torch.empty((2, 9, 5, 13), dtype=torch.uint8)
    assert library.dv_pileup_paint_plan(
        *[t.data_ptr() for t in tensors], struct, out.data_ptr(), 2, 4, 5,
        None) != 0
    # An output that is not 16-byte aligned.
    struct.planes = colors.planes
    assert library.dv_pileup_paint_plan(
        *[t.data_ptr() for t in tensors], struct, out.data_ptr() + 1, 2, 4,
        5, None) != 0

"""The port's pileup paint (deepvariant_tpu_torch.ops.pileup_paint)
against the JAX package's Pallas kernel and its XLA twin.

The plain PyTorch version must be bit-exact against both `_paint_xla`
and `_paint_pileup(..., interpret=True)`. The CUDA kernel itself runs
only on the card and is held against the plain version there by
chip_smoke.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepvariant_tpu.ops import pileup_paint as jax_pp
from deepvariant_tpu_torch.ops import pileup_paint as pp

torch.set_num_threads(2)


def _inputs(n=2, r=16, w=32, seed=0, edge=False):
    """tests/test_ops.py-style inputs; `edge` adds N bases, other bytes,
    q up to 255 and colors at the uint8 edges."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ACGTN*" if edge else b"ACGT", np.uint8)
    b = alphabet[rng.randint(0, len(alphabet), (n, r, w))]
    b[rng.rand(n, r, w) < 0.25] = 0
    q = rng.randint(0, 256 if edge else 60, (n, r, w)).astype(np.uint8)
    covered = b != 0
    if edge:
        covered &= rng.rand(n, r, w) < 0.9  # covered is its own input
    ref = alphabet[rng.randint(0, len(alphabet), (n, w))]
    hi = 256 if edge else 255
    colors = [rng.randint(0, hi, (n, r)).astype(np.float32)
              for _ in range(4)]
    if edge:
        colors[0][:, 0] = 254.0
        colors[1][:, 1] = 255.0
        colors[2][:, 2] = 0.0
        colors[3][:, 3] = 127.5
    return (b, q, covered, ref, *colors)


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


CASES = [dict(seed=0), dict(seed=1, edge=True),
         dict(n=3, r=95, w=221, seed=2, edge=True)]


@pytest.mark.parametrize("case", CASES, ids=["test_ops", "edge", "wgs"])
def test_reference_bit_exact_vs_xla(case):
    args = _inputs(**case)
    want = np.asarray(jax_pp._paint_xla(*args))
    got = pp.paint_pileup_reference(*_torch(args)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES[:2], ids=["test_ops", "edge"])
def test_reference_bit_exact_vs_interpreted_pallas(case):
    args = _inputs(**case)
    want = np.asarray(jax_pp._paint_pileup(*args, interpret=True))
    got = pp.paint_pileup_reference(*_torch(args)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_uses_plain_version_and_counts_nothing():
    args = _torch(_inputs(seed=3, edge=True))
    before = pp.paint_pileup.launches
    out = pp.paint_pileup(*args)
    assert pp.paint_pileup.launches == before
    assert torch.equal(out, pp.paint_pileup_reference(*args))


@pytest.mark.parametrize("index,bad,error", [
    (0, lambda t: t.to(torch.int32), TypeError),
    (2, lambda t: t.to(torch.uint8), TypeError),
    (4, lambda t: t.to(torch.float64), TypeError),
    (1, lambda t: t[:, :-1], ValueError),
    (3, lambda t: t[:1], ValueError),
    (5, lambda t: t[:, None], ValueError),
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
], ids=["b-dtype", "covered-dtype", "color-dtype", "q-shape", "ref-shape",
        "color-rank", "noncontiguous"])
def test_wrapper_rejects_bad_inputs(index, bad, error):
    args = _torch(_inputs(seed=4))
    args[index] = bad(args[index])
    with pytest.raises(error):
        pp.paint_pileup(*args)


def test_module_imports_without_nvcc_and_builds_nothing():
    code = (
        "import os, shutil\n"
        "os.environ['PATH'] = ''\n"
        "from deepvariant_tpu_torch.ops import pileup_paint, _build\n"
        "assert shutil.which('nvcc') is None\n"
        "assert 'pileup_paint' in _build.source_names()\n"
        "assert not _build._loaded\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo)

"""The control comes out as not correct: the reference computed one
precision below the configuration's bfloat16 (fp8 e4m3, per-tensor
scaled), put in the program's place, at each cell's own size on the
card and five seeds, fails at least one of the cell's limits; so does
half of each batch left out.

    python3 -m pytest benchmark/tests/test_bench_control.py -m chip
"""

import time

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]
# 2**31 + 901 and 4200000002: seeds on which half of each batch once
# passed the limits of an earlier, weaker comparison.
SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903, 2**31 + 904, 4200000002)
KINDS = ({"quant": "fp8"}, {"half_batch": True})


def fails_a_limit(cell, numbers):
    return any(numbers[name] > limit for name, limit in cell.limits.items()
               if name in numbers)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, name, seed):
    cell = harness.load_cell(name)
    drv = harness.driver(cell.traffic["driver"])
    ctx = harness.Context(cell=cell, seed=seed, seconds=1.0, trace=False,
                          device=card, t_process=time.time())
    for control, numbers in zip(KINDS, drv.control_readings(ctx, KINDS)):
        print(name, seed, control, numbers)
        assert fails_a_limit(cell, numbers), (control, numbers, cell.limits)

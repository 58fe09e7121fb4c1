"""A whole run of each cell at a small size on the CPU (the harness's
look for a card skipped), with the timed path broken underneath: each
fault that the cell can have makes `correct` come out false under the
cell's own limits. The faults: the state returned unchanged ('frozen'),
half of each batch left out and the mean taken over the rest ('half'),
the parameters' moving average left as it was ('ema'), and batch norm's
running statistics left as they were ('stats')."""

import time

import pytest

from benchmark import harness

TRAIN_FAULTS = ("frozen", "half", "ema", "stats")
CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


def tiny_run(name, fault=None, seed=2**31 + 77):
    cell = harness.load_cell(name)
    cell.traffic.update(corpus_examples=12)
    cell.config["batch_size"] = 4
    ctx = harness.Context(cell=cell, seed=seed, seconds=1.0, trace=False,
                          device="cpu", t_process=time.time(), fault=fault)
    return harness.run(ctx)


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in TRAIN_FAULTS])
def test_fault_makes_the_run_incorrect(name, fault):
    out = tiny_run(name, fault)
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]

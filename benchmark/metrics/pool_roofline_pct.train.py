"""Pooling: the pools' byte floor (`benchmark/pool_bytes.py`: each pool's
input and output once forward and once backward, at the cell's dtype)
at the card's memory rate, over `pool_ms.train`, in %."""

from benchmark import harness, pool_bytes
from benchmark.roofline import HBM_BYTES_PER_S


def read(out):
    ms = harness.metric_reader("pool_ms.train").read(out)
    floor = pool_bytes.step_bytes(out.facts)
    if not ms or floor is None:
        return None
    return 100.0 * floor / HBM_BYTES_PER_S * 1e3 / ms

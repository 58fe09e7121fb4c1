"""The pooling layer's byte floor: what the train step's pools must move.

Each pool of the network reads its input and writes its output once in
the forward, and reads the gradient of its output and writes that of its
input once in the backward; no implementation moves less. The shapes
come from the benchmark's own reference model (`reference/
inception_v3.py`), walked on the meta device with its two pools
(`_avg3`, `_max3`) watched, so no change to the port can move them. A
cell is found from the facts its run reports: the configuration file
under `configs/` whose training FLOPs an example equal
`flops_per_example`, at the cell's `batch`.
"""

from __future__ import annotations

import functools
import glob
import json
import os
from typing import Dict, Optional, Tuple

import torch

from benchmark import plans, roofline
from benchmark.reference import inception_v3 as ref

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "configs")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


@functools.lru_cache(maxsize=None)
def pool_elements(shape: Tuple[int, int, int]) -> Dict[str, int]:
    """{'avg': ..., 'max': ...}: the input and output elements of every
    pool of one (H, W, C) example, summed by kind."""
    counts = {"avg": 0, "max": 0}
    real = {"avg": ref._avg3, "max": ref._max3}

    def watched(kind):
        def pool(x):
            y = real[kind](x)
            counts[kind] += x.numel() + y.numel()
            return y
        return pool

    h, w, c = shape
    try:
        ref._avg3, ref._max3 = watched("avg"), watched("max")
        ref._network(ref._Walk(), torch.empty((1, c, h, w), device="meta"))
    finally:
        ref._avg3, ref._max3 = real["avg"], real["max"]
    return counts


def _config_for(flops_per_example: float) -> Optional[Dict]:
    for path in sorted(glob.glob(os.path.join(CONFIGS, "*.json"))):
        with open(path) as f:
            cfg = json.load(f)
        p = cfg["pileup"]
        shape = (p["height"], p["width"], plans.planes(p))
        if roofline.train_flops(*shape) == flops_per_example:
            return cfg
    return None


def step_bytes(facts: Dict) -> Optional[float]:
    """The bytes a train step's pools must move for the cell whose
    run reported `facts`, or None if no configuration matches."""
    flops, batch = facts.get("flops_per_example"), facts.get("batch")
    cfg = _config_for(flops) if flops else None
    if cfg is None or not batch:
        return None
    p = cfg["pileup"]
    counts = pool_elements((p["height"], p["width"], plans.planes(p)))
    return 2.0 * batch * sum(counts.values()) * ITEMSIZE[cfg["dtype"]]

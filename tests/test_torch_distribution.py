"""core/distribution.py of the PyTorch port against the JAX package's.

Pure Python over exact integer weights in both packages, so everything
is equal: every case of the JAX `tests/test_distribution.py` runs once
more on the port's module, and seeded weight maps go through
construction, `dist_map`, `dist_bind` and a traced generator in both
packages, whose weight maps, totals and reprs must match.
"""

import numpy as np
import pytest
import torch

import test_distribution
from deepvariant_tpu.core import distribution as jdist
from deepvariant_tpu_torch.core import distribution as tdist
from torch_multisample_util import port_twin, run_twin_case, twin_cases

torch.set_num_threads(2)

TWIN = port_twin(test_distribution)
CASES = twin_cases(TWIN)


def test_jax_cases_are_collected():
    assert len(CASES) == 19


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_jax_case_on_the_port(case):
    _id, cls_name, name, params = case
    run_twin_case(TWIN, cls_name, name, params)


def _weights(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    keys = rng.choice(40, size=rng.randint(2, 9), replace=False)
    return {int(k): int(w) for k, w in zip(keys, rng.randint(0, 6, len(keys)))
            if w} or {int(keys[0]): 2}


def _same(a, b):
    assert a.weight_map == b.weight_map
    assert a.total_weight == b.total_weight
    assert repr(a) == repr(b)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_distributions_equal_jax(seed):
    weights = _weights(seed)
    dists = [m.Distribution.from_weight_map(dict(weights))
             for m in (jdist, tdist)]
    _same(*dists)
    mapped = [m.dist_map(d, lambda x: x % 7)
              for m, d in zip((jdist, tdist), dists)]
    _same(*mapped)
    step = _weights(seed + 100)

    def binder(m):
        return lambda x: m.Distribution.from_weight_map(
            {x + k: w for k, w in step.items()})

    _same(*[m.dist_bind(d, binder(m)) for m, d in zip((jdist, tdist), dists)])

    def traced(m):
        gen = m.DistributionGenerator(
            lambda x: m.Distribution.from_weight_map(
                {x + k: w for k, w in weights.items()}))

        def f(provider):
            first = provider(seed)
            if first % 2:
                return first + provider(first % 5)
            return -first

        return m.dist_map(gen, f)

    _same(traced(jdist), traced(tdist))
    _same(jdist.uniform(sorted(weights)), tdist.uniform(sorted(weights)))
    _same(jdist.unit(seed), tdist.unit(seed))

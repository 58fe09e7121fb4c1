"""Shared inputs for the tests that hold the PyTorch port
(deepvariant_tpu_torch) against the JAX package."""

import numpy as np

from deepvariant_tpu_torch.models.inception_v3 import (
    InceptionV3,
    to_flax_variables,
)


def random_flax_variables(num_channels, seed=0):
    """An InceptionV3 {params, batch_stats} tree of numpy float32 arrays
    drawn from `seed`: He-scaled kernels, so activations keep their scale
    through the 94 layers and the classes separate, and non-trivial batch
    norm statistics. The same arrays go to both packages."""
    rng = np.random.RandomState(seed)
    layout = to_flax_variables(InceptionV3(num_channels))

    def fill(tree, collection):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value, collection)
                continue
            shape = value.shape
            if key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif key == "var":
                arr = rng.uniform(0.5, 1.5, shape)
            else:  # BN bias and mean, the Dense bias
                arr = rng.standard_normal(shape) * 0.1
            out[key] = arr.astype(np.float32)
        return out

    return {c: fill(t, c) for c, t in layout.items()}


def random_plans(n, seed, rows=95, width=221):
    """Stacked WGS plans with invalid rows, N bases, support codes 0..2,
    mapq above 60 and tlen negative and above 1000."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    bases = alphabet[rng.randint(0, 5, (n, rows, width))]
    bases[rng.rand(n, rows, width) < 0.3] = 0
    return {
        "bases": bases,
        "quals": rng.randint(0, 256, (n, rows, width)).astype(np.uint8),
        "mapq": rng.randint(0, 256, (n, rows)).astype(np.uint8),
        "rev": rng.rand(n, rows) < 0.5,
        "hp": rng.randint(0, 3, (n, rows)).astype(np.int8),
        "tlen": rng.randint(-3000, 3000, (n, rows)).astype(np.int32),
        "supp": rng.rand(n, rows) < 0.1,
        "support": rng.randint(0, 3, (n, rows)).astype(np.int8),
        "af": rng.randint(0, 256, (n, rows)).astype(np.uint8),
        "row_valid": rng.rand(n, rows) < 0.8,
        "ref_window": alphabet[rng.randint(0, 5, (n, width))],
    }


def edge_plans(plans):
    """Put the painter's edge values into stacked plans, in place: tlen
    at the int32 edges, -2**31 included, and support codes outside
    0..2, on valid rows. JAX wraps a negative code once and clamps: -2
    paints as 1, and -1 as 2."""
    n, rows = plans["tlen"].shape
    tlen = [-2**31, -2**31 + 1, 2**31 - 1, -1000, 1000][:rows]
    support = [-1, -2, -3, -128, 3, 127][:rows]
    plans["tlen"][0, :len(tlen)] = tlen
    plans["support"][n - 1, :len(support)] = support
    plans["row_valid"][0, :len(tlen)] = True
    plans["row_valid"][n - 1, :len(support)] = True
    return plans


def jax_images(plans, options):
    """The JAX package's long-read encoder on stacked plans (no alt
    planes): (N, band + R, W, C) uint8."""
    from deepvariant_tpu.make_examples.pileup_jax import (
        make_longread_encode_fn,
    )
    from deepvariant_tpu_torch.calling.plan_predictor import PLAN_KEYS

    n, rows, width = plans["bases"].shape
    alt = (np.zeros((n, 2, rows, width), np.uint8),
           np.zeros((n, 2, rows), bool), np.zeros((n, 2, width), np.uint8),
           np.zeros((n, 2), bool))
    encode = make_longread_encode_fn(options)
    return np.asarray(encode(*[plans[k] for k in PLAN_KEYS], *alt))

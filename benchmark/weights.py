"""Seeded weights, made on the device in a few large draws.

The convs are drawn He-normal (std sqrt(2 / fan_in)), so that the second
moment of the activations holds through the 94 conv layers in inference,
and the head lecun-normal. Batch norm gets biases, running means and
variances near `bn_bias`, 0 and 1. The same map goes to the port and to
the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.inception_v3 import param_shapes


def _leaves(shape) -> Tuple[Dict, Dict, Dict]:
    shapes = param_shapes(shape)
    kernels = {k: v for k, v in shapes.items() if k.endswith("weight")}
    biases = {k: v for k, v in shapes.items() if k.endswith("bias")}
    stats = {k: v for k, v in shapes.items()
             if k.endswith(".mean") or k.endswith(".var")}
    return kernels, biases, stats


def _split(flat: torch.Tensor, shapes: Dict) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, s in shapes.items():
        n = math.prod(s)
        out[name] = flat[at:at + n].view(s)
        at += n
    return out


def seeded_weights(shape, seed: int, device,
                   kernel_dtype: torch.dtype = torch.float32,
                   bn_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """{state-dict name: tensor} for (H, W, C) pileups: kernels in
    `kernel_dtype` (the dtype they are served in), the rest float32;
    batch norm's biases drawn around `bn_bias`."""
    kernels, biases, stats = _leaves(shape)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_k = sum(math.prod(s) for s in kernels.values())
    flat = torch.randn(n_k, generator=g, device=device, dtype=torch.float32)
    out = {}
    for name, w in _split(flat, kernels).items():
        fan_in = math.prod(w.shape[1:])
        gain = 1.0 if name.startswith("classification") else 2.0
        out[name] = (w * math.sqrt(gain / fan_in)).to(kernel_dtype)
    n_b = sum(math.prod(s) for s in biases.values())
    flat = torch.randn(n_b, generator=g, device=device) * 0.1 + bn_bias
    for name, b in _split(flat, biases).items():
        out[name] = b
    n_s = sum(math.prod(s) for s in stats.values())
    flat = torch.rand(n_s, generator=g, device=device)
    for name, s in _split(flat, stats).items():
        out[name] = (s - 0.5) * 0.2 if name.endswith(".mean") else \
            0.8 + 0.4 * s
    return out


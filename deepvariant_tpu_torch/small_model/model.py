"""Small-model MLP classifier + variant-calling gate.

The port's copy of `deepvariant_tpu.small_model.model`. Reference
parity: keras Sequential MLP with hidden layers (750, 750), relu, 3-way
softmax (small_model/keras_config.py:133-147, small_model_config.py:
83-99), here a torch module that training runs on the card; the
inference gate (`SmallModelVariantCaller`, small_model/inference.py:
75-200) accepts a candidate when the phred-scaled max class probability
clears the per-type GQ threshold, writing a CVO directly and skipping
the CNN.

The gate runs in numpy on the host, as in the JAX package: it runs
inside the make_examples workers, which never touch the card. Weights
travel as the flax tree {"params": {"Dense_i": {"kernel", "bias"}}}
(kernel (in, out)); `to_module_state` and `to_flax_variables` carry
them to and from the module's state dict (torch's Linear weight is
(out, in)).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from deepvariant_tpu_torch.core import genomics_math
from deepvariant_tpu_torch.core.types import CallVariantsOutput, Variant
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.make_examples.variant_caller import DeepVariantCall
from deepvariant_tpu_torch.models.inception_v3 import (
    tree_from_flax,
    tree_to_flax,
)

NUM_CLASSES = 3
DEFAULT_HIDDEN = (750, 750)
BUNDLE_NAME = "small_model.msgpack"


class SmallModelMLP(nn.Module):
    """`Dense_i` Linear layers (the flax names), relu between them and a
    softmax over the 3-way head."""

    def __init__(self, num_features: int,
                 hidden_layer_sizes: Tuple[int, ...] = DEFAULT_HIDDEN):
        super().__init__()
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        sizes = [num_features, *self.hidden_layer_sizes, NUM_CLASSES]
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"Dense_{i}", nn.Linear(fan_in, fan_out))

    def forward(self, x):
        layers = list(self.children())
        for layer in layers[:-1]:
            x = torch.relu(layer(x))
        return torch.softmax(layers[-1](x), dim=-1)


def to_module_state(variables) -> Dict[str, torch.Tensor]:
    """flax {"params": {"Dense_i": {kernel, bias}}} -> the module's state
    dict (each kernel transposed)."""
    return tree_from_flax(variables["params"])


def to_flax_variables(model_or_state) -> dict:
    """The module (or its state dict) -> the flax tree of float32 numpy
    arrays, kernels (in, out)."""
    state = model_or_state.state_dict() if isinstance(
        model_or_state, nn.Module) else model_or_state
    return {"params": tree_to_flax(state)}


def create_small_model(
    num_features: int,
    hidden_layer_sizes: Tuple[int, ...] = DEFAULT_HIDDEN,
    seed: int = 0,
):
    """Numpy-initialized variables in flax's param-tree layout, drawn as
    the JAX package draws them, and the float32 module on the host with
    those weights. Returns (module, variables)."""
    np_rng = np.random.RandomState(seed)
    sizes = [num_features, *hidden_layer_sizes, NUM_CLASSES]
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        # lecun_normal (flax Dense default initializer).
        scale = np.sqrt(1.0 / fan_in)
        params[f"Dense_{i}"] = {
            "kernel": (np_rng.randn(fan_in, fan_out) * scale).astype(
                np.float32
            ),
            "bias": np.zeros(fan_out, np.float32),
        }
    variables = {"params": params}
    model = SmallModelMLP(num_features, hidden_layer_sizes)
    model.load_state_dict(to_module_state(variables))
    return model, variables


def numpy_mlp_forward(variables, x: np.ndarray) -> np.ndarray:
    """Pure-numpy forward identical to SmallModelMLP.forward."""
    params = variables["params"]
    h = x.astype(np.float32)
    n_layers = len(params)
    for i in range(n_layers):
        layer = params[f"Dense_{i}"]
        h = h @ np.asarray(layer["kernel"]) + np.asarray(layer["bias"])
        if i < n_layers - 1:
            h = np.maximum(h, 0.0)
    h = h - h.max(axis=-1, keepdims=True)
    e = np.exp(h)
    return e / e.sum(axis=-1, keepdims=True)


def load_bundle(path: str, num_features: int, variables) -> tuple:
    """(variables, feature mean, feature scale) from a trained model: a
    directory holding small_model.msgpack, or the file itself. Reads the
    training bundle {params, mean, scale} or, as the JAX package's
    fallback does, raw variables (legacy checkpoints; mean and scale
    None). `variables` is the template the JAX package restores
    against: the layer names must be the same."""
    if os.path.isdir(path):
        # The reference flag takes a model DIRECTORY
        # (make_examples_options.py trained_small_model_path).
        path = os.path.join(path, BUNDLE_NAME)
    with open(path, "rb") as f:
        state = flax_msgpack.unpack(f.read())
    mean = scale = None
    if isinstance(state, dict) and set(state) == {"params", "mean", "scale"}:
        mean = np.asarray(state["mean"])
        scale = np.asarray(state["scale"])
        state = state["params"]
    if not (isinstance(state, dict) and set(state) == {"params"}
            and set(state["params"]) == set(variables["params"])):
        raise ValueError(
            f"{path} holds neither a small-model bundle nor variables with "
            f"layers {sorted(variables['params'])}")
    if mean is not None and (mean.shape != (num_features,)
                             or scale.shape != (num_features,)):
        raise ValueError(f"{path} normalizes {mean.shape} features, the "
                         f"examples have {num_features}")
    return state, mean, scale


def passes_confidence_threshold(
    class_probabilities: Sequence[float], threshold: float
) -> bool:
    """small_model/inference.py:55-65."""
    return genomics_math.ptrue_to_bounded_phred(
        max(class_probabilities)
    ) >= threshold


def _is_snp(variant: Variant) -> bool:
    return (len(variant.reference_bases) == 1
            and bool(variant.alternate_bases)
            and all(len(a) == 1 for a in variant.alternate_bases))


@dataclasses.dataclass
class SmallModelCallResult:
    cvos: List[CallVariantsOutput]
    # (candidate_index, alt_allele_indices) per ACCEPTED row: partially
    # accepted multiallelic candidates go to the CNN with only their
    # remaining alt-index sets (make_examples_alt_allele_indices,
    # small_model/inference.py:186-193, make_examples_native.cc:194).
    accepted_sets: List[Tuple[int, Tuple[int, ...]]]


class SmallModelVariantCaller:
    """Accept/forward gate over small-model probabilities
    (small_model/inference.py:75)."""

    def __init__(
        self,
        model: Optional[SmallModelMLP],
        variables,
        snp_gq_threshold: float = 25.0,
        indel_gq_threshold: float = 30.0,
    ):
        self.model = model
        self.variables = variables
        # Optional feature normalization from a trained bundle
        # (small_model.train writes mean/scale alongside params).
        self.feature_mean = None
        self.feature_scale = None
        self.snp_gq_threshold = snp_gq_threshold
        self.indel_gq_threshold = indel_gq_threshold

    def classify(self, examples: np.ndarray) -> np.ndarray:
        if self.feature_mean is not None:
            examples = (
                (examples - self.feature_mean) / self.feature_scale
            ).astype(np.float32)
        return numpy_mlp_forward(self.variables, examples)

    def _accept(self, candidate: DeepVariantCall,
                probabilities: Sequence[float]) -> bool:
        threshold = (self.snp_gq_threshold
                     if _is_snp(candidate.variant)
                     else self.indel_gq_threshold)
        return passes_confidence_threshold(probabilities, threshold)

    def call_variants(
        self,
        candidates_with_alt_indices: Sequence[
            Tuple[int, DeepVariantCall, Tuple[int, ...]]
        ],
        examples: np.ndarray,
    ) -> SmallModelCallResult:
        """Classify feature rows; accepted candidates become CVOs.

        `candidates_with_alt_indices`: (candidate_index, candidate,
        alt_allele_indices) aligned with `examples` rows.
        """
        if len(examples) == 0:
            return SmallModelCallResult([], [])
        probs = self.classify(examples.astype(np.float32))
        cvos: List[CallVariantsOutput] = []
        accepted_sets: List[Tuple[int, Tuple[int, ...]]] = []
        for (cand_idx, candidate, alt_indices), p in zip(
            candidates_with_alt_indices, probs
        ):
            p = [float(x) for x in p]
            total = sum(p) or 1.0
            p = [x / total for x in p]
            if self._accept(candidate, p):
                cvos.append(CallVariantsOutput(
                    variant=candidate.variant,
                    alt_allele_indices=list(alt_indices),
                    genotype_probabilities=genomics_math.round_gls(p),
                ))
                accepted_sets.append((cand_idx, tuple(alt_indices)))
        return SmallModelCallResult(cvos, accepted_sets)

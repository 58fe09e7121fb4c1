"""Import reference keras InceptionV3 weights into the port's model.

The port's copy of `deepvariant_tpu.models.keras_import`. The reference
trains tf.keras.applications.InceptionV3 backbones
(keras_modeling.py:246-330: include_top=False, pooling='avg', plus a
dropout + dense classification head). `convert_keras_inception` walks
any object with keras's layer interface (`.layers`, `.name`,
`get_weights()`, the layer class names) and returns the same flax-layout
numpy tree as the JAX package's; it imports no TensorFlow.
`load_keras_into_model` builds the port's InceptionV3 from that tree
through `from_flax_variables`.

Correspondence: `model.layers` is graph-depth-sorted, but keras's
auto-name counters (conv2d_N / batch_normalization_N) record creation
order, and the model declares its ConvBN submodules in exactly the
keras-applications creation sequence — so Conv2D and
BatchNormalization layers, sorted by name counter, zip 1:1 against
`FLAX_CONV_PATHS`.
Conv kernels share the (kh, kw, cin, cout) layout; BatchNorm runs with
scale=False (beta + moving statistics only) on both sides.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# Flax ConvBN paths in keras-applications creation order.
_A = ["b1x1", "b5x5_1", "b5x5_2", "b3x3dbl_1", "b3x3dbl_2",
      "b3x3dbl_3", "bpool"]
_RA = ["b3x3", "b3x3dbl_1", "b3x3dbl_2", "b3x3dbl_3"]
_B = ["b1x1", "b7x7_1", "b7x7_2", "b7x7_3", "b7x7dbl_1", "b7x7dbl_2",
      "b7x7dbl_3", "b7x7dbl_4", "b7x7dbl_5", "bpool"]
_RB = ["b3x3_1", "b3x3_2", "b7x7x3_1", "b7x7x3_2", "b7x7x3_3",
       "b7x7x3_4"]
_C = ["b1x1", "b3x3_1", "b3x3_2a", "b3x3_2b", "b3x3dbl_1",
      "b3x3dbl_2", "b3x3dbl_3a", "b3x3dbl_3b", "bpool"]

FLAX_CONV_PATHS: List[Tuple[str, ...]] = (
    [("stem1",), ("stem2",), ("stem3",), ("stem4",), ("stem5",)]
    + [("mixed0", n) for n in _A]
    + [("mixed1", n) for n in _A]
    + [("mixed2", n) for n in _A]
    + [("mixed3", n) for n in _RA]
    + [("mixed4", n) for n in _B]
    + [("mixed5", n) for n in _B]
    + [("mixed6", n) for n in _B]
    + [("mixed7", n) for n in _B]
    + [("mixed8", n) for n in _RB]
    + [("mixed9", n) for n in _C]
    + [("mixed10", n) for n in _C]
)


def _set(tree: Dict, path: Sequence[str], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def convert_keras_inception(keras_model, num_channels: int = 0):
    """keras model -> (params, batch_stats, head) in flax's layout.

    `keras_model` is either the full reference model (backbone +
    dense head) or a bare `tf.keras.applications.InceptionV3`
    backbone; with a backbone only, the classification head keeps
    fresh initialization. When `num_channels` differs from the
    checkpoint's, the stem conv is adapted with
    channels repeat-tiled then truncated (not
    models.inception_v3.adapt_input_channels' rule, as in the JAX
    package)."""
    conv_layers = []
    bn_layers = []
    dense_layers = []

    def walk(model):
        for layer in model.layers:
            cls = type(layer).__name__
            if cls in ("Functional", "Model"):
                walk(layer)
            elif cls == "Conv2D":
                conv_layers.append(layer)
            elif cls == "BatchNormalization":
                bn_layers.append(layer)
            elif cls == "Dense":
                dense_layers.append(layer)

    walk(keras_model)

    # model.layers is graph-depth-sorted; creation order (which is
    # what FLAX_CONV_PATHS mirrors) survives in the auto-assigned
    # name counters (conv2d, conv2d_1, ..., batch_normalization_N).
    def name_index(layer):
        tail = layer.name.rsplit("_", 1)[-1]
        return int(tail) if tail.isdigit() else -1

    conv_layers.sort(key=name_index)
    bn_layers.sort(key=name_index)
    if len(conv_layers) != len(FLAX_CONV_PATHS) or \
            len(bn_layers) != len(FLAX_CONV_PATHS):
        raise ValueError(
            "unexpected keras InceptionV3 structure: "
            f"{len(conv_layers)} convs / {len(bn_layers)} bns, want "
            f"{len(FLAX_CONV_PATHS)}"
        )

    params: Dict = {}
    batch_stats: Dict = {}
    for path, conv, bn in zip(FLAX_CONV_PATHS, conv_layers, bn_layers):
        kernel = np.asarray(conv.get_weights()[0])
        beta, mean, var = (np.asarray(w) for w in bn.get_weights())
        _set(params, (*path, "conv", "kernel"), kernel)
        _set(params, (*path, "bn", "bias"), beta)
        _set(batch_stats, (*path, "bn", "mean"), mean)
        _set(batch_stats, (*path, "bn", "var"), var)

    head = None
    if dense_layers:
        kernel, bias = (
            np.asarray(w) for w in dense_layers[-1].get_weights()
        )
        head = {"kernel": kernel, "bias": bias}

    if num_channels:
        stem = params["stem1"]["conv"]["kernel"]
        cin = stem.shape[2]
        if cin != num_channels:
            reps = int(np.ceil(num_channels / cin))
            stem = np.tile(stem, (1, 1, reps, 1))[:, :, :num_channels]
            params["stem1"]["conv"]["kernel"] = stem

    return params, batch_stats, head


def load_keras_into_model(keras_model, num_channels: int,
                          height: int = 100, width: int = 221,
                          device="cuda"):
    """Full path: build the port's float32 model for the target shape
    and splice in the keras weights. A keras backbone without its dense
    head leaves the head at the port's seed-0 initialisation. Returns
    (model on `device`, the flax {params, batch_stats} tree)."""
    from deepvariant_tpu_torch.models.inception_v3 import (
        create_model,
        from_flax_variables,
        prepare_for_inference,
        to_flax_variables,
    )

    model = create_model(num_channels, height=height, width=width,
                         dtype=torch.float32, device="cpu")
    variables = to_flax_variables(model)
    params, batch_stats, head = convert_keras_inception(
        keras_model, num_channels=num_channels
    )
    new_params = dict(variables["params"])
    for key, val in params.items():
        new_params[key] = val
    if head is not None:
        new_params["classification"] = head
    variables = {"params": new_params, "batch_stats": batch_stats}
    model.load_state_dict({k: v.float() for k, v in
                           from_flax_variables(variables).items()})
    return prepare_for_inference(model, device, torch.float32), variables

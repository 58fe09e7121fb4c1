"""Checkpoints: the JAX package's flax msgpack files, read and written.

Counterpart of `resolve_checkpoint_path` and `load_variables_for_shape`
in `deepvariant_tpu/scripts/call_variants.py`. Three layouts are read,
told apart by the keys present rather than by a template:
  * the lean inference bundle {params, batch_stats} (dv-export-model);
  * the resident trainer snapshot {params, batch_stats, ema_params,
    step} (training/train_resident.py);
  * the full TrainState {params, batch_stats, opt_state, ema_params,
    step} (training/train.py).
`save_variables` writes the lean bundle, which the JAX package loads;
`save_train_state` and `load_train_state` write and read the trainer's
states (training/train.py) in the layout of the JAX package's
`save_checkpoint`, which its `load_checkpoint` reads against a template.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.models.inception_v3 import (
    InceptionV3,
    create_model,
    from_flax_variables,
    prepare_for_inference,
    to_flax_variables,
    tree_from_flax,
    tree_to_flax,
)


def resolve_checkpoint_path(checkpoint: str) -> str:
    """Accepts a model directory (dv-export-model / dv-train output)
    or a direct .msgpack file; directories resolve to model.msgpack,
    then best.msgpack."""
    if checkpoint and os.path.isdir(checkpoint):
        for name in ("model.msgpack", "best.msgpack"):
            candidate = os.path.join(checkpoint, name)
            if os.path.exists(candidate):
                return candidate
        raise SystemExit(
            f"checkpoint directory {checkpoint} contains neither "
            "model.msgpack nor best.msgpack"
        )
    return checkpoint


def read_variables(blob: bytes, use_ema: bool = True) -> dict:
    """{params, batch_stats} from any of the three layouts; `use_ema`
    takes `ema_params` where the file has them."""
    state = flax_msgpack.unpack(blob)
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError("checkpoint has no 'params' tree")
    params = state["params"]
    if use_ema and "ema_params" in state:
        params = state["ema_params"]
    return {"params": params, "batch_stats": state.get("batch_stats", {})}


def load_variables_for_shape(
    checkpoint: str,
    shape: Sequence[int],
    expected_channels: Optional[Sequence[int]] = None,
    use_ema: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> InceptionV3:
    """The float32 model for (H, W, C) examples on `device`, with the
    checkpoint's weights, or seed-0 initial weights when `checkpoint` is
    empty. A checkpoint whose example_info.json names another shape is
    refused with a clear message instead of a weight-shape error."""
    checkpoint = resolve_checkpoint_path(checkpoint)
    h, w, c = shape
    model = create_model(c, height=h, width=w, dtype=torch.float32,
                         device="cpu")
    if checkpoint:
        ckpt_info_path = os.path.join(
            os.path.dirname(checkpoint), "example_info.json"
        )
        if os.path.exists(ckpt_info_path):
            with open(ckpt_info_path) as f:
                ckpt_info = json.load(f)
            if list(ckpt_info.get("shape", [])) and \
                    list(ckpt_info["shape"]) != [h, w, c]:
                raise SystemExit(
                    "example shape mismatch: checkpoint was trained "
                    f"on {ckpt_info['shape']} "
                    f"(channels {ckpt_info.get('channels')}), examples "
                    f"are {[h, w, c]} "
                    f"(channels {list(expected_channels or [])})"
                )
        with open(checkpoint, "rb") as f:
            variables = read_variables(f.read(), use_ema=use_ema)
        state = from_flax_variables(variables)
        want = model.state_dict()
        bad = sorted(k for k in want if k not in state or
                     tuple(state[k].shape) != tuple(want[k].shape))
        extra = sorted(k for k in state if k not in want)
        if bad or extra:
            raise ValueError(
                f"checkpoint {checkpoint} does not fit InceptionV3 for "
                f"{c} channels: missing or misshapen {bad[:5]}, "
                f"unexpected {extra[:5]}"
            )
        model.load_state_dict({k: v.float() for k, v in state.items()})
    return prepare_for_inference(model, device, torch.float32)


def load_variables_for_examples(
    checkpoint: str, examples_path: str, use_ema: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[InceptionV3, dict]:
    """The model for the examples' shape (from their example_info.json)
    with the checkpoint's weights, and that info."""
    info = example_codec.read_example_info(examples_path)
    model = load_variables_for_shape(
        checkpoint, info["shape"], expected_channels=info.get("channels"),
        use_ema=use_ema, device=device,
    )
    return model, info


def save_variables(path: str, model: InceptionV3,
                   example_info: Optional[dict] = None) -> None:
    """Write the lean {params, batch_stats} bundle, and example_info.json
    beside it when given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(flax_msgpack.pack(to_flax_variables(model)))
    if example_info is not None:
        with open(os.path.join(os.path.dirname(path),
                               "example_info.json"), "w") as f:
            json.dump(example_info, f)


# ---------------------------------------------------------------------------
# Training states: {params, batch_stats, opt_state, ema_params, step}
# ---------------------------------------------------------------------------

def _is_named_tree(node) -> bool:
    """A {state-dict name: tensor} map of the trainer's state (params,
    batch_stats, an optimizer moment), as against a tree level whose
    keys name collections, chain positions or state fields."""
    return (isinstance(node, dict) and bool(node)
            and all("." in k and isinstance(v, torch.Tensor)
                    for k, v in node.items()))


def state_to_flax(state):
    """A trainer state -> the tree flax serializes: each named map in
    flax's nested layout (kernels HWIO), every tensor a numpy array
    (int32 counts and steps as 0-d arrays)."""
    if _is_named_tree(state):
        return tree_to_flax(state)
    if isinstance(state, dict):
        return {k: state_to_flax(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    raise TypeError(f"cannot write {type(state).__name__} into a checkpoint")


def state_from_flax(tree, template):
    """The inverse of `state_to_flax` against `template`, as flax's
    `from_state_dict` restores against a target: the same keys at every
    level, each tensor with the template's shape, dtype, device and
    memory layout."""
    if _is_named_tree(template):
        named = tree_from_flax(tree)
        if set(named) != set(template):
            raise ValueError(
                "checkpoint tree does not match the state: missing "
                f"{sorted(set(template) - set(named))[:5]}, unexpected "
                f"{sorted(set(named) - set(template))[:5]}")
        return {k: _like(named[k], template[k]) for k in template}
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(
                f"checkpoint keys {sorted(tree) if isinstance(tree, dict) else tree!r} "
                f"do not match the state's {sorted(template)}")
        return {k: state_from_flax(tree[k], template[k]) for k in template}
    return _like(torch.from_numpy(np.array(tree)), template)


def _like(value: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    if tuple(value.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint array of shape {tuple(value.shape)} "
                         f"where the state has {tuple(template.shape)}")
    out = value.to(device=template.device, dtype=template.dtype)
    if template.dim() == 4 and template.is_contiguous(
            memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def save_train_state(path: str, state: dict) -> None:
    with open(path, "wb") as f:
        f.write(flax_msgpack.pack(state_to_flax(state)))


def load_train_state(path: str, template: dict) -> dict:
    with open(path, "rb") as f:
        return state_from_flax(flax_msgpack.unpack(f.read()), template)

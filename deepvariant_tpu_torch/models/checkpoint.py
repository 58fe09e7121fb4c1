"""Checkpoints: the JAX package's flax msgpack files, read and written.

Counterpart of `resolve_checkpoint_path` and `load_variables_for_shape`
in `deepvariant_tpu/scripts/call_variants.py`. Three layouts are read,
told apart by the keys present rather than by a template:
  * the lean inference bundle {params, batch_stats} (dv-export-model);
  * the resident trainer snapshot {params, batch_stats, ema_params,
    step} (training/train_resident.py);
  * the full TrainState {params, batch_stats, opt_state, ema_params,
    step} (training/train.py).
`save_variables` writes the lean bundle, which the JAX package loads.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple, Union

import torch

from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.models.inception_v3 import (
    InceptionV3,
    create_model,
    from_flax_variables,
    prepare_for_inference,
    to_flax_variables,
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

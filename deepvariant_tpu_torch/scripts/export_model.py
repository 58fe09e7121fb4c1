"""Export a training checkpoint for release/inference.

The port's copy of `deepvariant_tpu.scripts.export_model`. Reference
parity: convert_to_saved_model.py — takes a training checkpoint (full
state incl. optimizer), extracts the inference parameters (EMA by
default), and writes a lean inference bundle:
  <out>/model.msgpack        params + batch_stats only
  <out>/example_info.json    the data contract (shape + channels)
The checkpoint is read by its keys (`models.checkpoint.read_variables`),
not against a template, so a checkpoint of any optimizer exports; the
JAX package restores it against an SGD TrainState and refuses Adam and
RMSprop states. Host only: nothing here touches the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def export(checkpoint_path: str, output_dir: str, use_ema: bool = True,
           example_info_path: str = "") -> str:
    from deepvariant_tpu_torch.models.checkpoint import (
        load_variables_for_shape,
        save_variables,
    )

    info_path = example_info_path or os.path.join(
        os.path.dirname(checkpoint_path), "example_info.json"
    )
    with open(info_path) as f:
        info = json.load(f)
    # The checkpoint's tree is checked against the model for this shape
    # on the way through.
    model = load_variables_for_shape(checkpoint_path, info["shape"],
                                     use_ema=use_ema, device="cpu")
    out_path = os.path.join(output_dir, "model.msgpack")
    save_variables(out_path, model, info)
    return out_path


def load_exported(model_dir: str, device="cuda"):
    """Load an exported bundle -> (float32 model on `device`, its flax
    {params, batch_stats} tree, example_info)."""
    from deepvariant_tpu_torch.models.checkpoint import (
        load_variables_for_shape,
        read_variables,
    )

    with open(os.path.join(model_dir, "example_info.json")) as f:
        info = json.load(f)
    path = os.path.join(model_dir, "model.msgpack")
    model = load_variables_for_shape(path, info["shape"], device=device)
    with open(path, "rb") as f:
        variables = read_variables(f.read())
    return model, variables, info


def main(argv=None) -> int:
    p = argparse.ArgumentParser("export_model")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--example_info", default="")
    args = p.parse_args(argv)
    out = export(args.checkpoint, args.output_dir, args.use_ema,
                 args.example_info)
    print(f"export_model: wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

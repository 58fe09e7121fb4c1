"""Import a reference keras InceptionV3 checkpoint (.h5 / .keras) into
an inference bundle (model.msgpack + example_info.json), ready for
call_variants --checkpoint <dir> and export_model.load_exported.

The port's copy of `deepvariant_tpu.scripts.import_keras_model`. Reading
the keras file needs TensorFlow, imported in `main` only; the converter
(models.keras_import) needs none. Host only.

Usage:
  python -m deepvariant_tpu_torch.scripts.import_keras_model \
    --keras_model model.h5 --num_channels 7 --output_dir release/
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser("import_keras_model")
    p.add_argument("--keras_model", required=True,
                   help=".h5 or .keras file of the reference "
                        "InceptionV3 (backbone or full model)")
    p.add_argument("--num_channels", type=int, required=True)
    p.add_argument("--height", type=int, default=100)
    p.add_argument("--width", type=int, default=221)
    p.add_argument("--channels", default="",
                   help="comma-separated channel enums for "
                        "example_info.json (data contract)")
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)

    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "import_keras_model reads keras files with TensorFlow, which "
            "is not installed") from e

    from deepvariant_tpu_torch.io import flax_msgpack
    from deepvariant_tpu_torch.models.keras_import import (
        load_keras_into_model,
    )

    keras_model = tf.keras.models.load_model(
        args.keras_model, compile=False
    )
    _, variables = load_keras_into_model(
        keras_model, args.num_channels, args.height, args.width,
        device="cpu",
    )
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, "model.msgpack")
    with open(out_path, "wb") as f:
        f.write(flax_msgpack.pack(variables))
    info = {
        "version": "1.10.0",
        "shape": [args.height, args.width, args.num_channels],
        "channels": [int(c) for c in args.channels.split(",") if c],
    }
    with open(os.path.join(args.output_dir, "example_info.json"),
              "w") as f:
        json.dump(info, f)
    print(f"import_keras_model: wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

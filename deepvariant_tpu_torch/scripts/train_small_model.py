"""Train the small-model MLP on feature rows emitted by
make_examples --write_small_model_examples (reference small_model
training pipeline, small_model_config.py presets).

The port's copy of `deepvariant_tpu.scripts.train_small_model`, plus
`--device`: training runs on the CUDA card unless `--device cpu` is
given; a request for CUDA without a card raises.

Usage:
  python -m deepvariant_tpu_torch.scripts.train_small_model \
    --train_examples train_small.tfrecord@8 \
    --output_dir small_model_release --config wgs [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser("train_small_model")
    p.add_argument("--train_examples", required=True)
    p.add_argument("--tune_examples", default="")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--config", default="wgs",
                   choices=["wgs", "pacbio", "ont", "test"])
    p.add_argument("--num_epochs", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to train (default: the CUDA card)")
    args = p.parse_args(argv)

    from deepvariant_tpu_torch.small_model.train import (
        get_config,
        train_small_model,
    )

    config = get_config(args.config)
    if args.num_epochs:
        config.num_epochs = args.num_epochs
    if args.batch_size:
        config.batch_size = args.batch_size
    metrics = train_small_model(
        args.train_examples, args.output_dir, config,
        tune_path=args.tune_examples, device=args.device,
    )
    print(f"train_small_model done: {metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

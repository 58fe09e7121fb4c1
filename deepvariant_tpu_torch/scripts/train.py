"""Training CLI (reference train.py flag surface, config-driven).

Usage:
  python -m deepvariant_tpu_torch.scripts.train --config wgs \
    --train_dataset_config train_ds.pbtxt \
    --tune_dataset_config tune_ds.pbtxt \
    --experiment_dir /out/exp1 [--batch_size N] [--num_epochs N] \
    [--device cuda|cpu]

The port's copy of `deepvariant_tpu.scripts.train`, plus `--device`.
Dataset configs are DeepVariantDatasetConfig pbtxt (or .json) files
(training.data.DatasetConfig: name / tfrecord_path / num_examples).
Training runs on one CUDA card unless `--device cpu` is given; a request
for CUDA without a card raises. Launched by torchrun it trains
data-parallel, one process per card (NCCL; gloo with `--device cpu`):

  torchrun --nproc_per_node=<cards> -m deepvariant_tpu_torch.scripts.train \
    --config wgs --train_dataset_config ... --experiment_dir ...
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser("train")
    p.add_argument("--config", default="wgs",
                   help="preset: wgs/exome/pacbio/ont or *_test")
    p.add_argument("--train_dataset_config", required=True)
    p.add_argument("--tune_dataset_config", required=True)
    p.add_argument("--experiment_dir", required=True)
    p.add_argument("--init_checkpoint", default="")
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--num_epochs", type=int, default=0)
    p.add_argument("--limit", type=int, default=0,
                   help="cap steps per epoch/tune pass (smoke runs)")
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to train (default: the CUDA card)")
    args = p.parse_args(argv)

    import dataclasses

    from deepvariant_tpu_torch.parallel.distribute import (
        initialize_multihost,
        shutdown,
    )
    from deepvariant_tpu_torch.training.config import get_config
    from deepvariant_tpu_torch.training.train import train

    config = get_config(args.config)
    overrides = {
        "train_dataset_config": args.train_dataset_config,
        "tune_dataset_config": args.tune_dataset_config,
    }
    if args.init_checkpoint:
        overrides["init_checkpoint"] = args.init_checkpoint
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.num_epochs:
        overrides["num_epochs"] = args.num_epochs
    if args.limit:
        overrides["limit"] = args.limit
    config = dataclasses.replace(config, **overrides)
    # torchrun's variables, when it launched this process; else one rank.
    initialize_multihost(device=args.device)
    try:
        metrics = train(
            config, args.experiment_dir, device=args.device,
            max_steps=args.max_steps or None,
        )
    finally:
        shutdown()
    print(f"train done: {metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

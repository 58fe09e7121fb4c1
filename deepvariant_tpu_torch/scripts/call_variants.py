"""call_variants CLI (stage 2): examples TFRecord -> CVO TFRecord.

Counterpart of `deepvariant_tpu/scripts/call_variants.py`, with the same
flags and exit codes plus `--device`: inference runs on CUDA, in
bfloat16, unless `--device cpu` asks for the CPU, where it runs in
float32. The checkpoint is a flax msgpack file from the JAX package or
the port (models/checkpoint.py), or seed-0 initial weights for smoke
runs with --allow_uninitialized_model. `resolve_checkpoint_path`,
`load_variables_for_examples` and `load_variables_for_shape` (the
shape-based loaders that the stream and run_deepvariant use) are those
of models/checkpoint.py, importable from here as from the JAX CLI; in
the port the loaded weights live in the returned model.

Run: python -m deepvariant_tpu_torch.scripts.call_variants \\
       --examples ex.tfrecord.gz --outfile cvo.tfrecord.gz --checkpoint dir
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from deepvariant_tpu_torch.calling.call_variants import call_variants
from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.models.checkpoint import (  # noqa: F401
    load_variables_for_examples,
    load_variables_for_shape,
    resolve_checkpoint_path,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("call_variants")
    p.add_argument("--examples", required=True)
    p.add_argument("--outfile", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--allow_uninitialized_model", action="store_true",
                   help="run with fresh-init weights (smoke testing only)")
    p.add_argument("--include_debug_info", action="store_true",
                   help="emit CallVariantsOutput.DebugInfo (predicted/"
                        "true label, variant class flags)")
    p.add_argument("--limit", type=int, default=0,
                   help="process at most this many examples (0 = all)")
    p.add_argument("--max_batches", type=int, default=0,
                   help="process at most this many batches (0 = all)")
    p.add_argument("--allow_empty_examples",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="succeed on empty example inputs (writes an "
                        "empty CVO file); --no-allow_empty_examples "
                        "errors instead")
    p.add_argument(
        "--fast_graph", action="store_true",
        help="inference-graph fast path: fold batch norm into the "
             "convs and pad the stem input channels to 8 (both exact "
             "rewrites, models/inception_v3.py). Output probabilities "
             "differ from the default graph at rounding level.")
    p.add_argument(
        "--writer_threads", type=int, default=0,
        help="CVO writer processes (reference call_variants.py:189). "
        "0 = autodetect: 1 when inference runs on CPU, all cores "
        "(max 16) when it runs on CUDA.",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def resolve_writer_processes(writer_threads: int,
                             device: torch.device) -> int:
    """Autodetect rule (reference call_variants.py:805-821): explicit
    value wins; otherwise 1 on CPU, min(cpus, 16) on the card."""
    if writer_threads > 0:
        return min(writer_threads, 16)
    if device.type == "cpu":
        return 1
    return min(os.cpu_count() or 1, 16)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.checkpoint and not args.allow_uninitialized_model:
        print("error: --checkpoint is required (or pass "
              "--allow_uninitialized_model for smoke runs)",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    model, _ = load_variables_for_examples(
        args.checkpoint, args.examples, use_ema=args.use_ema, device=device
    )
    stats = call_variants(
        args.examples, args.outfile, model,
        batch_size=args.batch_size, device=device,
        dtype=torch.float32 if device.type == "cpu" else torch.bfloat16,
        num_writers=resolve_writer_processes(args.writer_threads, device),
        include_debug_info=args.include_debug_info,
        limit=args.limit, max_batches=args.max_batches,
        fast_graph=args.fast_graph,
    )
    if stats["num_examples"] == 0 and not args.allow_empty_examples:
        print("error: no examples found (pass --allow_empty_examples "
              "to accept empty inputs)", file=sys.stderr)
        return 1
    print(
        f"call_variants done: {stats['num_examples']} examples at "
        f"{stats['examples_per_sec']:.1f} examples/s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

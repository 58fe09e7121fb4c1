"""One-step oracle-inference command (reference
scripts/run_oracle_inference.py:30-488).

The port's copy of `deepvariant_tpu.scripts.run_oracle_inference`, host
only: the port's make_examples in training mode, its shards spawned
(none touches the card), then the port's labeled_examples_to_vcf.

An "oracle" run measures the ceiling of what a perfectly-trained model
could call from the generated examples: it runs make_examples in
TRAINING mode (so every candidate is labeled against the truth set)
and then converts the labeled examples straight into a VCF via
labeled_examples_to_vcf — no CNN involved. Differences between the
oracle VCF and the truth set therefore isolate candidate-generation /
labeling losses from model losses.

Stage wiring mirrors the reference: make_examples fans out across
--num_shards processes (the reference uses GNU parallel --halt 2,
run_oracle_inference.py:296-323), with the preset-driven knobs the
reference hard-codes (BASE_CHANNELS channel list, 1500
max_reads_per_partition, partition_size 1000 — 25000 for
PACBIO/ONT_R104, run_oracle_inference.py:308-313); then
labeled_examples_to_vcf writes the oracle VCF
(run_oracle_inference.py:326-355).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
import time

# The same comma-separated flag=value parser as run_deepvariant's
# --make_examples_extra_args.
from deepvariant_tpu_torch.scripts.run_deepvariant import (  # noqa: F401
    extra_args_to_argv,
    split_extra_args,
)

MODEL_TYPES = (
    "WGS",
    "WES",
    "PACBIO",
    "ONT_R104",
    "HYBRID_PACBIO_ILLUMINA",
    "MASSEQ",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_oracle_inference")
    p.add_argument("--model_type", choices=MODEL_TYPES, required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--reads", required=True)
    p.add_argument("--output_vcf", required=True)
    p.add_argument("--truth_variants", required=True,
                   help="VCF of truth variants the labeler matches")
    p.add_argument("--confident_regions", required=True,
                   help="BED of confident regions for labeling")
    p.add_argument("--labeler_algorithm", default="haplotype_labeler",
                   choices=("haplotype_labeler", "positional_labeler"))
    p.add_argument("--haploid_contigs", default=None)
    p.add_argument("--par_regions_bed", default=None)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--regions", default=None)
    p.add_argument("--sample_name", default=None)
    p.add_argument("--intermediate_results_dir", default="")
    p.add_argument("--logging_dir", default="")
    p.add_argument("--make_examples_extra_args", default=None)
    p.add_argument("--dry_run", action="store_true",
                   help="print the stage commands without running them")
    return p


def _run_make_examples_shard(args_tuple):
    import io
    from contextlib import redirect_stdout

    from deepvariant_tpu_torch.scripts.make_examples import main as me_main

    argv, task = args_tuple
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = me_main(argv + ["--task", str(task)])
    return rc, buf.getvalue()


def create_all_commands(args) -> list:
    """Returns [(stage_name, argv), ...] for the two oracle stages."""
    outdir = args.intermediate_results_dir
    n = max(args.num_shards, 1)
    examples_spec = os.path.join(
        outdir, f"make_examples.tfrecord@{n}.gz"
    )

    # The reference oracle applies NO model-type preset: model_type only
    # selects partition_size, and only PACBIO/ONT_R104 get the long-read
    # 25000 value (run_oracle_inference.py:308-313). MASSEQ intentionally
    # stays at 1000 to match.
    long_read = args.model_type in ("PACBIO", "ONT_R104")
    partition_size = 25000 if long_read else 1000
    me_argv = [
        "--mode", "training",
        "--ref", args.ref,
        "--reads", args.reads,
        "--examples", examples_spec,
        "--num_shards", str(n),
        "--truth_variants", args.truth_variants,
        "--confident_regions", args.confident_regions,
        "--labeler_algorithm", args.labeler_algorithm,
        "--channel_list", "BASE_CHANNELS",
        "--max_reads_per_partition", "1500",
        "--partition_size", str(partition_size),
    ]
    if args.regions:
        me_argv += ["--regions", args.regions]
    if args.sample_name:
        me_argv += ["--sample_name", args.sample_name]
    if args.haploid_contigs:
        me_argv += ["--haploid_contigs", args.haploid_contigs]
    if args.par_regions_bed:
        me_argv += ["--par_regions_bed", args.par_regions_bed]
    me_argv += extra_args_to_argv(args.make_examples_extra_args)

    le_argv = [
        "--ref", args.ref,
        "--examples", examples_spec,
        "--output_vcf", args.output_vcf,
    ]
    if args.sample_name:
        le_argv += ["--sample_name", args.sample_name]

    return [("make_examples", me_argv),
            ("labeled_examples_to_vcf", le_argv)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    if not args.intermediate_results_dir:
        args.intermediate_results_dir = tempfile.mkdtemp(
            prefix="oracle_inference_"
        )
    os.makedirs(args.intermediate_results_dir, exist_ok=True)
    if args.logging_dir:
        os.makedirs(args.logging_dir, exist_ok=True)

    commands = create_all_commands(args)
    print(
        "***** Intermediate results will be written to "
        f"{args.intermediate_results_dir} *****"
    )
    for stage, stage_argv in commands:
        print(f"\n***** Running {stage}: *****\n  {' '.join(stage_argv)}")
        if args.dry_run:
            continue
        t0 = time.time()
        if stage == "make_examples":
            n = max(args.num_shards, 1)
            outputs = []
            if n == 1:
                rc, out = _run_make_examples_shard((stage_argv, 0))
                outputs.append(out)
            else:
                rc = 0
                # Spawned, as run_deepvariant's shards are: a forked
                # child would inherit whatever CUDA state this process
                # holds.
                ctx = multiprocessing.get_context("spawn")
                with ctx.Pool(n) as pool:
                    for shard_rc, out in pool.imap_unordered(
                        _run_make_examples_shard,
                        [(stage_argv, task) for task in range(n)],
                    ):
                        outputs.append(out)
                        if shard_rc != 0:
                            rc = shard_rc
                            pool.terminate()
                            break
            text = "".join(outputs)
        else:
            import io
            from contextlib import redirect_stdout

            from deepvariant_tpu_torch.labeler.labeled_examples_to_vcf import (
                main as le_main,
            )

            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = le_main(stage_argv)
            text = buf.getvalue()
        print(text, end="")
        if args.logging_dir:
            with open(
                os.path.join(args.logging_dir, f"{stage}.log"), "w"
            ) as f:
                f.write(text)
        if rc != 0:
            print(f"{stage} failed (rc={rc})")
            return rc
        print(f"{stage}: {time.time() - t0:.1f}s")
    if not args.dry_run:
        print(f"total: {time.time() - t_start:.1f}s -> {args.output_vcf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

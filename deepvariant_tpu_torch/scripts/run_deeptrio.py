"""One-step DeepTrio pipeline (reference scripts/run_deeptrio.py).

The port's copy of the JAX package's one-step script, with its flags plus
`--device`. Runs trio make_examples once per target sample (child,
parent1, parent2 — the reference's per-sample example outputs) on the
host, then call_variants on `--device` (default `cuda`; a missing card
raises before make_examples starts, `--device cpu` runs on the CPU in
float32) and postprocess_variants per sample, producing three VCFs.
Pileup heights follow the reference's per-model presets
(run_deeptrio.py:392-399: WGS/PacBio child 60 / parent 40; WES/ONT
100/100); every target stacks the same three heights, so the child's
and the parents' examples share one shape (140x221x7 for WGS).
`--num_shards`, which the JAX script accepts and reads nowhere, is
refused at any value but 1.

Run: python -m deepvariant_tpu_torch.scripts.run_deeptrio --ref ref.fa \
       --reads_child c.bam --reads_parent1 p1.bam --reads_parent2 p2.bam \
       --output_vcf_child c.vcf.gz --checkpoint_child dir
"""

from __future__ import annotations

import argparse
import os
import sys
import time

MODEL_TYPES = ("WGS", "WES", "PACBIO", "ONT")
HEIGHTS = {  # model_type -> (child, parent) (run_deeptrio.py:392-399)
    "WGS": (60, 40), "PACBIO": (60, 40),
    "WES": (100, 100), "ONT": (100, 100),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_deeptrio")
    p.add_argument("--model_type", choices=MODEL_TYPES, default="WGS")
    p.add_argument("--ref", required=True)
    p.add_argument("--reads_child", required=True)
    p.add_argument("--reads_parent1", required=True)
    p.add_argument("--reads_parent2", required=True)
    p.add_argument("--sample_name_child", default="child")
    p.add_argument("--sample_name_parent1", default="parent1")
    p.add_argument("--sample_name_parent2", default="parent2")
    p.add_argument("--output_vcf_child", required=True)
    p.add_argument("--output_vcf_parent1", default="")
    p.add_argument("--output_vcf_parent2", default="")
    p.add_argument("--checkpoint_child", default="")
    p.add_argument("--checkpoint_parent", default="")
    p.add_argument("--regions", default=None)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--intermediate_results_dir", default="")
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--allow_uninitialized_model", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


# The flag the JAX script accepts and reads nowhere, with the only value
# the port takes.
UNREAD_FLAGS = {"num_shards": 1}


def main(argv=None) -> int:
    from deepvariant_tpu_torch.device import resolve_device
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.multisample import (
        SampleSpec,
        make_multisample_examples_runner,
        refuse_unread_flags,
    )
    from deepvariant_tpu_torch.scripts.call_variants import main as cv_main
    from deepvariant_tpu_torch.scripts.postprocess_variants import (
        main as pp_main,
    )

    args = build_parser().parse_args(argv)
    refuse_unread_flags(args, UNREAD_FLAGS)
    # Refuse a missing card before stage 1 runs.
    resolve_device(args.device)
    t_start = time.time()
    outdir = args.intermediate_results_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.output_vcf_child)),
        "intermediate_results_dir",
    )
    os.makedirs(outdir, exist_ok=True)
    h_child, h_parent = HEIGHTS[args.model_type]

    child = SampleSpec("child", args.reads_child,
                       args.sample_name_child, h_child)
    parent1 = SampleSpec("parent1", args.reads_parent1,
                         args.sample_name_parent1, h_parent)
    parent2 = SampleSpec("parent2", args.reads_parent2,
                         args.sample_name_parent2, h_parent)

    # Per-target sample stacks (deeptrio/make_examples.py order=:
    # child & parent1 use [parent1, child, parent2]; parent2 swaps the
    # parents, order [2,1,0]).
    targets = [("child", [parent1, child, parent2], 1,
                args.output_vcf_child, args.checkpoint_child)]
    if args.output_vcf_parent1:
        targets.append(("parent1", [parent1, child, parent2], 0,
                        args.output_vcf_parent1, args.checkpoint_parent))
    if args.output_vcf_parent2:
        targets.append(("parent2", [parent2, child, parent1], 0,
                        args.output_vcf_parent2, args.checkpoint_parent))

    for role, samples, main_idx, output_vcf, checkpoint in targets:
        t0 = time.time()
        examples = os.path.join(
            outdir, f"make_examples_{role}.tfrecord.gz"
        )
        options = MakeExamplesOptions(
            reads_filename=samples[main_idx].reads_filename,
            ref_filename=args.ref,
            examples_filename=examples,
            mode="calling",
            regions=args.regions.split() if args.regions else None,
            sample_name=samples[main_idx].sample_name,
        )
        options.variant_caller_options.min_fraction_multiplier = 0.67
        options.pileup_options.channels = (1, 2, 3, 4, 5, 6, 19)
        counts = make_multisample_examples_runner(
            options, samples, main_idx
        )
        print(f"make_examples[{role}]: {counts} "
              f"({time.time() - t0:.1f}s)")

        cvo = os.path.join(outdir, f"cvo_{role}.tfrecord.gz")
        cv_argv = ["--examples", examples, "--outfile", cvo,
                   "--batch_size", str(args.batch_size),
                   "--device", args.device]
        if checkpoint:
            cv_argv += ["--checkpoint", checkpoint]
        elif args.allow_uninitialized_model:
            cv_argv += ["--allow_uninitialized_model"]
        rc = cv_main(cv_argv)
        if rc != 0:
            return rc

        rc = pp_main([
            "--ref", args.ref,
            "--infile", cvo,
            "--outfile", output_vcf,
            "--sample_name", samples[main_idx].sample_name,
        ])
        if rc != 0:
            return rc
        print(f"{role}: {output_vcf}")
    print(f"total: {time.time() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One-step pangenome-aware pipeline
(reference scripts/run_pangenome_aware_deepvariant.py).

The port's copy of the JAX package's one-step script, with its flags plus
`--device`. Stacks a pangenome haplotype panel above the sample reads
([pangenome, reads], reads as the calling sample) with the panel's
channels blanked and only window-spanning haplotypes kept
(make_examples_pangenome_aware_dv.py:207-289) on the host, then
call_variants on `--device` (default `cuda`; a missing card raises
before make_examples starts, `--device cpu` runs on the CPU in float32)
and postprocess_variants.

The panel is a BAM of haplotype alignments or a .gbz graph, decoded by
io/gbz.py into `pangenome_panel.bam` (every haplotype of the file).
This script sets trim_reads_for_pileup=True as the JAX one does; the
multi-sample builders are made without it in both packages, so the
examples are painted untrimmed (ROADMAP.md Queue 3). Refused, because
the JAX script accepts them and reads them nowhere: `--num_shards` at
any value but 1 and `--model_type` at any value but WGS.

Run: python -m deepvariant_tpu_torch.scripts.run_pangenome_aware_deepvariant \
       --ref ref.fa --reads reads.bam --pangenome panel.gbz \
       --output_vcf out.vcf.gz --checkpoint dir
"""

from __future__ import annotations

import argparse
import os
import sys
import time

MODEL_TYPES = ("WGS", "WES")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("run_pangenome_aware_deepvariant")
    p.add_argument("--model_type", choices=MODEL_TYPES, default="WGS")
    p.add_argument("--ref", required=True)
    p.add_argument("--reads", required=True)
    p.add_argument("--pangenome", required=True,
                   help="haplotype panel (BAM of haplotype alignments "
                        "or .gbz graph)")
    p.add_argument("--sample_name_reads", default="default")
    p.add_argument("--output_vcf", required=True)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--regions", default=None)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--intermediate_results_dir", default="")
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--allow_uninitialized_model", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


# The flags the JAX script accepts and reads nowhere, with the only value
# the port takes.
UNREAD_FLAGS = {"num_shards": 1, "model_type": "WGS"}


def main(argv=None) -> int:
    from deepvariant_tpu_torch.device import resolve_device
    from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
    from deepvariant_tpu_torch.make_examples.multisample import (
        PANGENOME_MAIN_SAMPLE_INDEX,
        make_multisample_examples_runner,
        pangenome_samples,
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
        os.path.dirname(os.path.abspath(args.output_vcf)),
        "intermediate_results_dir",
    )
    os.makedirs(outdir, exist_ok=True)
    examples = os.path.join(
        outdir, "make_examples_pangenome.tfrecord.gz"
    )

    pangenome_path = args.pangenome
    if pangenome_path.endswith(".gbz"):
        from deepvariant_tpu_torch.io.gbz import extract_panel_bam

        pangenome_path = extract_panel_bam(
            pangenome_path, args.ref,
            os.path.join(outdir, "pangenome_panel.bam"),
        )

    options = MakeExamplesOptions(
        reads_filename=args.reads,
        ref_filename=args.ref,
        examples_filename=examples,
        mode="calling",
        regions=args.regions.split() if args.regions else None,
        sample_name=args.sample_name_reads,
        # The pangenome preset's default, copied as the JAX script sets
        # it; the multi-sample builders never receive it.
        trim_reads_for_pileup=True,
    )
    options.pileup_options.channels = (1, 2, 3, 4, 5, 6, 19)
    options.variant_caller_options.min_fraction_multiplier = float("inf")

    t0 = time.time()
    samples = pangenome_samples(
        args.reads, pangenome_path,
        sample_name_reads=args.sample_name_reads,
    )
    counts = make_multisample_examples_runner(
        options, samples, PANGENOME_MAIN_SAMPLE_INDEX
    )
    print(f"make_examples: {counts} ({time.time() - t0:.1f}s)")

    cvo = os.path.join(outdir, "cvo_pangenome.tfrecord.gz")
    cv_argv = ["--examples", examples, "--outfile", cvo,
               "--batch_size", str(args.batch_size),
               "--device", args.device]
    if args.checkpoint:
        cv_argv += ["--checkpoint", args.checkpoint]
    elif args.allow_uninitialized_model:
        cv_argv += ["--allow_uninitialized_model"]
    rc = cv_main(cv_argv)
    if rc != 0:
        return rc

    rc = pp_main([
        "--ref", args.ref,
        "--infile", cvo,
        "--outfile", args.output_vcf,
        "--sample_name", args.sample_name_reads,
    ])
    if rc != 0:
        return rc
    print(f"total: {time.time() - t_start:.1f}s -> {args.output_vcf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

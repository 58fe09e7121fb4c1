"""Multi-sample make_examples CLIs (DeepTrio / DeepSomatic / generic).

The port's copy of the JAX package's `multisample_make_examples` CLI,
with the same sub-commands, flags and outputs. It mirrors
deeptrio/make_examples.py, deepvariant/make_examples_somatic.py and
multisample_make_examples.py mains. Like the port's `make_examples`
CLI it runs on the host only and takes no --device. A `.gbz` panel is
decoded into `<examples stem>.panel.bam` with every haplotype of the
file, as the JAX CLI writes it (its `--regions` bounds the calling
regions, not the panel).

Usage:
  python -m deepvariant_tpu_torch.scripts.multisample_make_examples trio \
      --ref ref.fa --reads_child c.bam --reads_parent1 p1.bam \
      --reads_parent2 p2.bam --examples out.tfrecord
  python -m deepvariant_tpu_torch.scripts.multisample_make_examples somatic \
      --ref ref.fa --reads_tumor t.bam --reads_normal n.bam \
      --examples out.tfrecord
"""

from __future__ import annotations

import argparse
import sys

from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
from deepvariant_tpu_torch.make_examples.multisample import (
    SampleSpec,
    TRIO_MAIN_SAMPLE_INDEX,
    make_multisample_examples_runner,
    somatic_samples,
    trio_samples,
)


def _common_args(p: argparse.ArgumentParser):
    p.add_argument("--ref", required=True)
    p.add_argument("--examples", required=True)
    p.add_argument("--candidates", default="")
    p.add_argument("--gvcf", default="")
    p.add_argument("--regions", default=None)
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=0)
    p.add_argument("--realign_reads", action=argparse.BooleanOptionalAction,
                   default=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("multisample_make_examples")
    sub = p.add_subparsers(dest="product", required=True)

    trio = sub.add_parser("trio")
    _common_args(trio)
    trio.add_argument("--reads_child", required=True)
    trio.add_argument("--reads_parent1", required=True)
    trio.add_argument("--reads_parent2", required=True)
    trio.add_argument("--sample_name_child", default="child")
    trio.add_argument("--sample_name_parent1", default="parent1")
    trio.add_argument("--sample_name_parent2", default="parent2")

    somatic = sub.add_parser("somatic")
    _common_args(somatic)
    somatic.add_argument("--reads_tumor", required=True)
    somatic.add_argument(
        "--reads_normal", default="",
        help="omit for tumor-only calling (make_examples_somatic.py "
             "tumor_normal_samples_from_flags single-sample path)")
    somatic.add_argument("--sample_name_tumor", default="tumor")
    somatic.add_argument("--sample_name_normal", default="normal")

    pangenome = sub.add_parser(
        "pangenome",
        help="pangenome-aware examples: haplotype panel stacked above "
             "the sample reads (make_examples_pangenome_aware_dv.py)",
    )
    _common_args(pangenome)
    pangenome.add_argument("--reads", required=True)
    pangenome.add_argument(
        "--pangenome", required=True,
        help="haplotype panel: alignments (BAM) or a .gbz pangenome "
             "graph (decoded natively by io.gbz.extract_panel_bam, "
             "the GbzReader/load_gbz_into_shared_memory analog)")
    pangenome.add_argument("--sample_name_reads", default="reads")
    pangenome.add_argument("--sample_name_pangenome",
                           default="pangenome")
    pangenome.add_argument(
        "--variant_types_to_blank", default="",
        help="comma-separated SNP,INDEL: blank the pangenome plane "
             "for these variant types")
    pangenome.add_argument(
        "--keep_only_window_spanning_haplotypes",
        action=argparse.BooleanOptionalAction, default=True)
    pangenome.add_argument(
        "--ref_chrom_prefix", default="",
        help="contig prefix present in --ref but absent in the "
             "pangenome panel (e.g. 'chr')")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.product == "trio":
        samples = trio_samples(
            args.reads_child, args.reads_parent1, args.reads_parent2,
            args.sample_name_child, args.sample_name_parent1,
            args.sample_name_parent2,
        )
        main_index = TRIO_MAIN_SAMPLE_INDEX
        main_reads = args.reads_child
        sample_name = args.sample_name_child
    elif args.product == "somatic":
        if args.reads_normal:
            samples = somatic_samples(
                args.reads_tumor, args.reads_normal,
                args.sample_name_tumor, args.sample_name_normal,
            )
            main_index = 1
        else:
            # Tumor-only (make_examples_somatic.py
            # tumor_normal_samples_from_flags when reads_normal unset).
            samples = [SampleSpec(
                "tumor", args.reads_tumor, args.sample_name_tumor, 100,
            )]
            main_index = 0
        main_reads = args.reads_tumor
        sample_name = args.sample_name_tumor
    else:
        from deepvariant_tpu_torch.make_examples.multisample import (
            PANGENOME_MAIN_SAMPLE_INDEX,
            pangenome_samples,
        )

        pangenome_path = args.pangenome
        if pangenome_path.endswith(".gbz"):
            import os

            from deepvariant_tpu_torch.io.gbz import extract_panel_bam

            pangenome_path = extract_panel_bam(
                pangenome_path, args.ref,
                os.path.splitext(args.examples)[0] + ".panel.bam",
            )
        samples = pangenome_samples(
            args.reads, pangenome_path,
            args.sample_name_reads, args.sample_name_pangenome,
            variant_types_to_blank=[
                v for v in args.variant_types_to_blank.split(",") if v
            ],
            keep_only_window_spanning_haplotypes=(
                args.keep_only_window_spanning_haplotypes
            ),
        )
        samples[0].chrom_prefix = args.ref_chrom_prefix
        main_index = PANGENOME_MAIN_SAMPLE_INDEX
        main_reads = args.reads
        sample_name = args.sample_name_reads
    options = MakeExamplesOptions(
        reads_filename=main_reads,
        ref_filename=args.ref,
        examples_filename=args.examples,
        candidates_filename=args.candidates,
        gvcf_filename=args.gvcf,
        mode="calling",
        regions=args.regions.split() if args.regions else None,
        sample_name=sample_name,
        task_id=args.task,
        num_shards=args.num_shards,
        realigner_enabled=args.realign_reads,
    )
    counts = make_multisample_examples_runner(options, samples, main_index)
    print(
        f"{args.product} make_examples done: {counts['examples']} "
        f"examples, {counts['candidates']} candidates"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

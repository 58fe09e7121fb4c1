"""postprocess_variants CLI (stage 3): CVO TFRecord -> VCF / gVCF.

The port's copy of `deepvariant_tpu.scripts.postprocess_variants`, with
the same flags (the reference postprocess_variants.py main, :2232).
Stage 3 runs on the host: this CLI needs no card. Each output ending in
`.gz` (the VCF and the gVCF) is BGZF and gets a tabix index.
`--vcf_stats_report` writes `<outfile base>.stats.json` and
`.visual_report.html` beside the VCF with the port's `tools/vcf_stats`.

    python -m deepvariant_tpu_torch.scripts.postprocess_variants \
        --ref ref.fa --infile cvo.tfrecord.gz --outfile out.vcf.gz \
        [--nonvariant_site_tfrecord_path gvcf.tfrecord.gz \
         --gvcf_outfile out.g.vcf.gz]
"""

from __future__ import annotations

import argparse
import sys

from deepvariant_tpu_torch.core.ranges import RangeSet, read_bed
from deepvariant_tpu_torch.io.fasta import FastaReader
from deepvariant_tpu_torch.io.tabix import build_index
from deepvariant_tpu_torch.postprocess.pipeline import (
    fasta_ref_lookup,
    postprocess_variants,
    postprocess_variants_parallel,
)
from deepvariant_tpu_torch.tools import vcf_stats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("postprocess_variants")
    p.add_argument("--ref", required=True)
    p.add_argument("--infile", required=True, help="CVO tfrecord(s)")
    p.add_argument("--small_model_cvo_records", default="",
                   help="additional CVOs from the small model")
    p.add_argument("--outfile", required=True, help="output VCF(.gz)")
    p.add_argument("--nonvariant_site_tfrecord_path", default="")
    p.add_argument("--gvcf_outfile", default="")
    p.add_argument("--sample_name", default="")
    p.add_argument("--qual_filter", type=float, default=1.0)
    p.add_argument("--multi_allelic_qual_filter", type=float, default=1.0)
    p.add_argument("--cnn_homref_call_min_gq", type=float, default=20.0)
    p.add_argument("--multiallelic_mode", default="product",
                   choices=["min", "product"])
    p.add_argument("--haploid_contigs", default="")
    p.add_argument("--par_regions_bed", default="")
    p.add_argument("--only_keep_pass", action="store_true")
    p.add_argument("--use_csi", action="store_true",
                   help="write a .csi index instead of .tbi (contigs "
                        "longer than 2^29 bp)")
    p.add_argument("--group_variants",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--use_multiallelic_model", action="store_true",
                   help="resolve two-alt sites with the trained "
                        "multiallelic MLP instead of product fusion")
    p.add_argument("--phased_reads_switches_output_path", default="",
                   help="switches TSV from merge_phased_reads; enables "
                        "cross-region phase-set stitching")
    p.add_argument("--process_somatic", action="store_true",
                   help="DeepSomatic output: het calls become GT 0/0 "
                        "with the GERMLINE filter")
    p.add_argument("--pon_filtering", default="",
                   help="Panel-of-Normals VCF; PASS variants matching "
                        "it get the PON filter (somatic only)")
    p.add_argument("--regions", default="",
                   help="space-separated region literals or BED paths; "
                        "restrict emitted records")
    p.add_argument("--vcf_stats_report", action="store_true",
                   help="write the <outfile>.visual_report.html stats "
                        "page after the VCF")
    p.add_argument("--debug_output_all_candidates", default=None,
                   choices=["ALT", "INFO"],
                   help="emit all considered candidates: INFO adds a "
                        "CANDIDATES info field; ALT keeps filtered "
                        "alleles as zero-probability ALTs")
    p.add_argument("--cpus", type=int, default=0,
                   help="worker processes for partitioned postprocess "
                        "(reference --cpus); 0 = single process")
    p.add_argument("--num_partitions", type=int, default=0,
                   help="contig-range partitions when --cpus > 0 "
                        "(default: same as --cpus)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ref = FastaReader(args.ref)
    haploid = None
    if args.haploid_contigs:
        haploid = {
            c for part in args.haploid_contigs.split(",")
            for c in part.split()
        }
    par_regions = None
    if args.par_regions_bed:
        par_regions = RangeSet(read_bed(args.par_regions_bed))

    sample_name = args.sample_name or _sample_name_from_cvos(args.infile) \
        or "default"
    regions = None
    if args.regions:
        regions = RangeSet.from_regions(args.regions.split())
    infiles = [args.infile]
    if args.small_model_cvo_records:
        infiles.append(args.small_model_cvo_records)
    if args.cpus > 0:
        # Partition-parallel path (postprocess_variants.py:1887): only
        # the plain-VCF flow partitions; gVCF merge stays single
        # process like the reference's merge step.
        if args.nonvariant_site_tfrecord_path:
            raise SystemExit(
                "--cpus parallelism applies to the VCF-only flow; "
                "run gVCF merging without --cpus"
            )
        stats = postprocess_variants_parallel(
            infiles,
            args.outfile,
            ref.contigs,
            sample_name=sample_name,
            num_partitions=args.num_partitions or args.cpus,
            processes=args.cpus,
            qual_filter=args.qual_filter,
            multi_allelic_qual_filter=args.multi_allelic_qual_filter,
            cnn_homref_call_min_gq=args.cnn_homref_call_min_gq,
            multiallelic_mode=args.multiallelic_mode,
            haploid_contigs=haploid,
            par_regions=par_regions,
        )
        print(
            f"postprocess_variants done: {stats['vcf_records']} VCF "
            f"records across {stats['partitions']} partitions"
        )
        return 0
    stats = postprocess_variants(
        infiles,
        args.outfile,
        ref.contigs,
        sample_name=sample_name,
        qual_filter=args.qual_filter,
        multi_allelic_qual_filter=args.multi_allelic_qual_filter,
        cnn_homref_call_min_gq=args.cnn_homref_call_min_gq,
        multiallelic_mode=args.multiallelic_mode,
        haploid_contigs=haploid,
        par_regions=par_regions,
        nonvariant_site_path=args.nonvariant_site_tfrecord_path or None,
        output_gvcf=args.gvcf_outfile or None,
        ref_lookup=fasta_ref_lookup(ref),
        only_keep_pass=args.only_keep_pass,
        group_variants=args.group_variants,
        phased_reads_switches_path=(
            args.phased_reads_switches_output_path or None
        ),
        use_multiallelic_model=args.use_multiallelic_model,
        process_somatic=args.process_somatic,
        pon_vcf_path=args.pon_filtering or None,
        regions=regions,
        debug_output_all_candidates=args.debug_output_all_candidates,
    )
    # Tabix-index bgzipped outputs (postprocess_variants.py:1583
    # build_index).
    for out in (args.outfile, args.gvcf_outfile):
        if out and out.endswith(".gz"):
            build_index(out, use_csi=args.use_csi)
    if args.vcf_stats_report:
        base = args.outfile
        for suffix in (".gz", ".vcf"):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
        vcf_stats.main([
            "--input_vcf", args.outfile, "--outfile_base", base,
        ])
    print(
        f"postprocess_variants done: {stats['vcf_records']} VCF records"
        + (f", {stats['gvcf_records']} gVCF records"
           if args.gvcf_outfile else "")
    )
    return 0


def _sample_name_from_cvos(path: str):
    """Sample name from the first CVO (postprocess_variants.py:1633)."""
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
    from deepvariant_tpu_torch.core.types import CallVariantsOutput
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader

    for p in glob_sharded_inputs(path):
        try:
            with TFRecordReader(p) as reader:
                for buf in reader:
                    cvo = CallVariantsOutput.decode(buf)
                    if cvo.variant.calls:
                        return cvo.variant.calls[0].call_set_name
                    return None
        except FileNotFoundError:
            continue
    return None


if __name__ == "__main__":
    sys.exit(main())

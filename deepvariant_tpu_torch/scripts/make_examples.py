"""make_examples CLI (stage 1).

The port's copy of `deepvariant_tpu.scripts.make_examples`: the same
flags (the reference's make_examples_options.py surface), funneled into
MakeExamplesOptions, with `check_options_are_valid` cross-checks, the
same exit codes and messages, and the serialized options recorded in
the run_info sidecar. Stage 1 runs on the host and needs no card: the
pileups are painted by `pileup.PileupEncoder.build_pileup`. The
read-side options run as in the JAX package (`--normalize_reads`,
`--use_original_quality_scores`, `--enable_methylation_calling`,
`--enable_methylation_aware_phasing`, `--parse_sam_aux_fields` with
MM/ML, the aux-driven channels of `--channel_list`), and so does
`--mode candidate_sweep`, which, as there, runs the calling runner (the
positions file is `core.candidate_sweep_runner`'s). `--reads` takes a
BAM or a CRAM, and `--mode training` labels the examples from
`--truth_variants` and `--confident_regions` with any
`--labeler_algorithm`. The small model's flags run its gate
(`--call_small_model_examples`, its CVOs to `--small_model_cvo_records`)
and write its training rows (`--write_small_model_examples`). Options
whose code the port does not have yet (`--denovo_regions`), the
small-model flags the JAX package never reads at other values than
their defaults, and `--write_small_model_examples` with `--phase_reads`
raise NotImplementedError through `refuse_unported_options`, naming
their ROADMAP.md entry. `--stream_examples`/`--shm_*` are refused as in the
JAX package (the fused stream replaces them), and `--hts_block_size` is
accepted and does nothing (the IO layer reads whole BGZF blocks).

Usage:
  python -m deepvariant_tpu_torch.scripts.make_examples \
    --mode calling --ref ref.fa --reads reads.bam \
    --examples out.tfrecord@4 --task 0
"""

from __future__ import annotations

import argparse
import sys

from deepvariant_tpu_torch.make_examples.core import (
    DEFAULT_MAX_READS_PER_PARTITION,
    DEFAULT_PARTITION_SIZE,
    DEFAULT_RANDOM_SEED,
    MakeExamplesOptions,
    OptionsError,
    check_options_are_valid,
    make_examples_runner,
)

SEQUENCING_TYPES = {
    "": 0, "UNSPECIFIED_SEQ_TYPE": 0, "WGS": 1, "WES": 2,
    "TRIO": 3, "ONT": 4, "PACBIO": 5,
}


def _bool_flag(p, name, default, help_=""):
    p.add_argument(f"--{name}", action=argparse.BooleanOptionalAction,
                   default=default, help=help_)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("make_examples")

    # -- core IO / mode ----------------------------------------------------
    p.add_argument("--mode",
                   choices=["calling", "training", "candidate_sweep"],
                   required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--reads", required=True)
    p.add_argument("--examples", required=True)
    p.add_argument("--candidates", default="")
    p.add_argument("--gvcf", default="")
    p.add_argument("--regions", default=None,
                   help="space-separated region literals or BED paths")
    p.add_argument("--exclude_regions", default=None)
    p.add_argument("--sample_name", default="default")
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=0,
                   help="0 = unsharded")
    _bool_flag(p, "use_ref_for_cram", True,
               "decode CRAM against --ref instead of embedded refs")
    _bool_flag(p, "discard_non_dna_regions", False,
               "skip regions whose reference bases are all N")
    _bool_flag(p, "deterministic_serialization", True,
               "accepted for parity; the byte-level example codec is "
               "always deterministic")
    _bool_flag(p, "write_run_info", True)
    _bool_flag(p, "output_sitelist", False,
               "write candidate positions TSV beside the examples")
    p.add_argument("--logging_every_n_candidates", type=int, default=2000)
    p.add_argument("--hts_block_size", type=int, default=0,
                   help="accepted for parity; the IO layer reads whole "
                        "BGZF blocks regardless")

    # -- region partitioning / read intake ---------------------------------
    p.add_argument("--partition_size", type=int,
                   default=DEFAULT_PARTITION_SIZE)
    p.add_argument("--max_reads_per_partition", type=int,
                   default=DEFAULT_MAX_READS_PER_PARTITION)
    p.add_argument("--max_reads_for_dynamic_bases_per_region", type=int,
                   default=0)
    p.add_argument("--random_seed", type=int, default=DEFAULT_RANDOM_SEED)
    _bool_flag(p, "keep_duplicates", False)
    _bool_flag(p, "keep_secondary_alignments", False)
    _bool_flag(p, "keep_supplementary_alignments", False)
    _bool_flag(p, "parse_sam_aux_fields", None,
               "parse aux tags eagerly (HP/MM/ML parse on demand "
               "otherwise)")
    p.add_argument("--aux_fields_to_keep", default="HP,MM,ML",
                   help="comma-separated aux tags kept when parsing")
    _bool_flag(p, "use_original_quality_scores", False,
               "replace base qualities with the OQ tag")
    p.add_argument("--min_mapping_quality", type=int, default=5)
    p.add_argument("--min_base_quality", type=int, default=10)

    # -- variant caller -----------------------------------------------------
    p.add_argument("--variant_caller", default="very_sensitive_caller",
                   choices=["very_sensitive_caller",
                            "vcf_candidate_importer"])
    p.add_argument("--proposed_variants", default="",
                   help="VCF of candidates to import "
                        "(vcf_candidate_importer)")
    p.add_argument("--vsc_min_count_snps", type=int, default=2)
    p.add_argument("--vsc_min_count_indels", type=int, default=2)
    p.add_argument("--vsc_min_fraction_snps", type=float, default=0.12)
    p.add_argument("--vsc_min_fraction_indels", type=float, default=0.06)
    p.add_argument("--vsc_min_fraction_multiplier", type=float,
                   default=1.0)
    p.add_argument("--vsc_max_fraction_snps_for_non_target_sample",
                   type=float, default=0.0)
    p.add_argument("--vsc_max_fraction_indels_for_non_target_sample",
                   type=float, default=0.0)
    p.add_argument("--vsc_min_indel_fraction_for_small_indels",
                   type=float, default=0.0)
    p.add_argument("--vsc_min_indel_fraction_for_large_indels",
                   type=float, default=0.0)
    p.add_argument("--vsc_small_indel_threshold", type=int, default=0)
    _bool_flag(p, "use_rejected_alleles", False)
    _bool_flag(p, "create_complex_alleles", False,
               "merge adjacent SNP+indel evidence into complex alleles")
    p.add_argument("--p_error", type=float, default=0.001)
    p.add_argument("--gvcf_gq_binsize", type=int, default=5)
    _bool_flag(p, "include_med_dp", False)
    p.add_argument("--training_random_emit_ref_sites", type=float,
                   default=0.0)
    p.add_argument("--haploid_contigs", default=None,
                   help="space/comma-separated contigs called haploid")
    p.add_argument("--par_regions_bed", default=None,
                   help="BED of pseudoautosomal regions kept diploid "
                        "on haploid contigs")
    p.add_argument("--select_variant_types", default=None,
                   help="whitespace list among: snps indels "
                        "multi-allelics all")
    p.add_argument("--exclude_variants_vcf_filename", default=None)
    p.add_argument("--exclude_variants_af_threshold", type=float,
                   default=0.05)
    _bool_flag(p, "filter_low_vaf_candidates", False)
    p.add_argument("--low_vaf_threshold", type=float, default=0.05)
    p.add_argument("--low_vaf_max_base_quality", type=int, default=30)
    p.add_argument("--low_vaf_max_mapping_quality", type=int, default=30)
    _bool_flag(p, "track_ref_reads", False)
    _bool_flag(p, "keep_legacy_allele_counter_behavior", False)
    _bool_flag(p, "normalize_reads", False,
               "left-align per-read indels before allele counting")

    # -- realignment --------------------------------------------------------
    _bool_flag(p, "realign_reads", True)
    p.add_argument("--max_read_length_to_realign", type=int, default=500)
    _bool_flag(p, "enable_strict_insertion_filter", False)
    _bool_flag(p, "enable_joint_realignment", False)
    # RNA-seq: split spliced (N-CIGAR) alignments into per-exon reads
    # before realignment (reference realigner.py:230).
    _bool_flag(p, "split_skip_reads", False)
    _bool_flag(p, "trim_reads_for_pileup", False)

    # -- pileup images ------------------------------------------------------
    p.add_argument("--pileup_image_width", type=int, default=0,
                   help="0 = default 221")
    p.add_argument("--alt_aligned_pileup", default="none",
                   choices=["none", "base_channels", "diff_channels",
                            "rows"])
    p.add_argument("--types_to_alt_align", default="indels",
                   choices=["indels", "all"])
    p.add_argument("--multi_allelic_mode", default="",
                   choices=["", "add_het_alt_images", "no_het_alt_images"])
    p.add_argument("--channels", default=None,
                   help="legacy comma-separated opt-channel list "
                        "(appended to the base six)")
    p.add_argument("--channel_list", default="",
                   help="comma-separated channel names overriding the "
                        "preset's channel set")
    _bool_flag(p, "add_hp_channel", False,
               "append the haplotype_tag channel")
    _bool_flag(p, "add_supporting_other_alt_color", False)
    _bool_flag(p, "sort_by_haplotypes", False)
    _bool_flag(p, "reverse_haplotypes", False)
    _bool_flag(p, "sort_by_alt_allele_support", False)
    p.add_argument("--hp_tag_for_assembly_polishing", type=int, default=0)
    _bool_flag(p, "use_allele_frequency", False,
               "append the allele_frequency channel (needs "
               "--population_vcfs)")
    p.add_argument("--population_vcfs", default="",
                   help="space-separated population VCFs with AF INFO")
    p.add_argument("--mean_coverage_per_sample", default="",
                   help="mean coverage value(s) for the mean_coverage "
                        "channel (first value used for this sample)")
    _bool_flag(p, "sample_mean_coverage_on_calling_regions", False)
    p.add_argument("--sequencing_type", default=None,
                   choices=sorted(SEQUENCING_TYPES))
    _bool_flag(p, "skip_pileup_image_generation", False)
    _bool_flag(p, "use_non_uniform_downsampling", False)
    p.add_argument("--non_uniform_downsampling_threshold", type=int,
                   default=3)

    # -- phasing ------------------------------------------------------------
    _bool_flag(p, "phase_reads", False)
    p.add_argument("--min_alleles_to_phase", type=int, default=1)
    p.add_argument("--phase_max_candidates", type=int, default=5000)
    p.add_argument("--output_local_read_phasing", default=None)
    p.add_argument("--output_phasing_error_stats", default=None)
    _bool_flag(p, "output_phase_info", False)
    _bool_flag(p, "assign_phase_from_normal", False)
    _bool_flag(p, "enable_methylation_calling", False)
    p.add_argument("--methylation_calling_threshold", type=float,
                   default=0.5)
    _bool_flag(p, "enable_methylation_aware_phasing", False)
    p.add_argument("--exclude_contigs_for_methylation_phasing",
                   default="chrX chrY")

    # -- training / labeling -------------------------------------------------
    p.add_argument("--truth_variants", default="")
    p.add_argument("--confident_regions", default="")
    p.add_argument("--labeler_algorithm", default="haplotype_labeler")
    p.add_argument("--customized_classes_labeler_classes_list",
                   default="")
    p.add_argument("--customized_classes_labeler_info_field_name",
                   default="")
    p.add_argument("--downsample_classes", default=None,
                   help="comma-separated per-class keep probabilities")
    p.add_argument("--downsample_fraction", type=float, default=0.0,
                   help="keep each read with this probability at read "
                        "time (0 disables)")
    p.add_argument("--hts_io_threads", type=int, default=0,
                   help="host BGZF inflation threads for the reads "
                        "file (htslib bgzf-threads analog; 0=inline)")
    p.add_argument("--denovo_regions", default="")
    _bool_flag(p, "output_debug_info", False)

    # -- small model ---------------------------------------------------------
    _bool_flag(p, "call_small_model_examples", False)
    p.add_argument("--trained_small_model_path", default="")
    p.add_argument("--checkpoint", default="",
                   help="alias of --trained_small_model_path")
    p.add_argument("--checkpoint_json", default="",
                   help="alias small-model bundle sidecar (unused when "
                        "the bundle embeds normalization)")
    p.add_argument("--small_model_snp_gq_threshold", type=float,
                   default=25.0)
    p.add_argument("--small_model_indel_gq_threshold", type=float,
                   default=30.0)
    _bool_flag(p, "small_model_call_multiallelics", True)
    _bool_flag(p, "small_model_emit_all_candidates", False)
    p.add_argument("--small_model_inference_batch_size", type=int,
                   default=128)
    p.add_argument("--small_model_vaf_context_window_size", type=int,
                   default=51)
    p.add_argument("--small_model_cvo_records", default="",
                   help="output TFRecord for small-model CVOs")
    _bool_flag(p, "write_small_model_examples", False)
    p.add_argument("--small_model_examples", default="",
                   help="output TFRecord for small-model training rows")

    # -- replaced-by-architecture surface ------------------------------------
    _bool_flag(p, "stream_examples", False,
               "reference shm streaming; replaced by the device "
               "prefetch pipeline")
    p.add_argument("--shm_prefix", default="")
    p.add_argument("--shm_buffer_size", type=int, default=10485760)

    # -- ours (kept for compatibility with earlier rounds) -------------------
    p.add_argument("--runtime_by_region", default="")
    p.add_argument("--model_preset", default="",
                   help="apply a model type's calling flags "
                        "(WGS/WES/PACBIO/ONT_R104/...)")
    return p


def options_from_args(args) -> MakeExamplesOptions:
    options = MakeExamplesOptions(
        reads_filename=args.reads,
        ref_filename=args.ref,
        examples_filename=args.examples,
        candidates_filename=args.candidates,
        gvcf_filename=args.gvcf,
        mode=args.mode,
        regions=args.regions.split() if args.regions else None,
        exclude_regions=(
            args.exclude_regions.split() if args.exclude_regions else None
        ),
        sample_name=args.sample_name,
        task_id=args.task,
        num_shards=args.num_shards,
        partition_size=args.partition_size,
        max_reads_per_partition=args.max_reads_per_partition,
        max_reads_for_dynamic_bases_per_region=(
            args.max_reads_for_dynamic_bases_per_region
        ),
        random_seed=args.random_seed,
        realigner_enabled=args.realign_reads,
        min_mapping_quality=args.min_mapping_quality,
        min_base_quality=args.min_base_quality,
        sequencing_type=SEQUENCING_TYPES.get(
            args.sequencing_type or "", 0
        ),
        include_med_dp=args.include_med_dp,
        variant_caller=args.variant_caller,
        call_small_model_examples=args.call_small_model_examples,
        trained_small_model_path=(
            args.trained_small_model_path or args.checkpoint
        ),
        small_model_snp_gq_threshold=args.small_model_snp_gq_threshold,
        small_model_indel_gq_threshold=(
            args.small_model_indel_gq_threshold
        ),
        small_model_vaf_context_window_size=(
            args.small_model_vaf_context_window_size
        ),
        small_model_call_multiallelics=(
            args.small_model_call_multiallelics
        ),
        small_model_emit_all_candidates=(
            args.small_model_emit_all_candidates
        ),
        small_model_inference_batch_size=(
            args.small_model_inference_batch_size
        ),
        small_model_cvo_filename=args.small_model_cvo_records,
        write_small_model_examples=args.write_small_model_examples,
        small_model_examples_filename=args.small_model_examples,
        population_vcf_filenames=(
            args.population_vcfs.split() if args.population_vcfs else None
        ),
        proposed_variants_filename=args.proposed_variants,
        truth_variants_filename=args.truth_variants,
        confident_regions_filename=args.confident_regions,
        labeler_algorithm=args.labeler_algorithm,
        customized_classes_labeler_classes_list=(
            args.customized_classes_labeler_classes_list
        ),
        customized_classes_labeler_info_field_name=(
            args.customized_classes_labeler_info_field_name
        ),
        downsample_classes=(
            [float(x) for x in args.downsample_classes.split(",")]
            if args.downsample_classes else None
        ),
        downsample_fraction=args.downsample_fraction,
        hts_io_threads=args.hts_io_threads,
        denovo_regions=(
            args.denovo_regions.split() if args.denovo_regions else None
        ),
        select_variant_types=args.select_variant_types,
        exclude_variants_vcf_filename=(
            args.exclude_variants_vcf_filename or ""
        ),
        exclude_variants_af_threshold=args.exclude_variants_af_threshold,
        keep_duplicates=args.keep_duplicates,
        keep_secondary_alignments=args.keep_secondary_alignments,
        keep_supplementary_alignments=args.keep_supplementary_alignments,
        parse_sam_aux_fields=args.parse_sam_aux_fields,
        aux_fields_to_keep=(
            [t.strip() for t in args.aux_fields_to_keep.split(",")]
            if args.aux_fields_to_keep else None
        ),
        use_original_quality_scores=args.use_original_quality_scores,
        use_ref_for_cram=args.use_ref_for_cram,
        max_read_length_to_realign=args.max_read_length_to_realign,
        enable_joint_realignment=args.enable_joint_realignment,
        assign_phase_from_normal=args.assign_phase_from_normal,
        phase_reads=args.phase_reads,
        min_alleles_to_phase=args.min_alleles_to_phase,
        phase_max_candidates=args.phase_max_candidates,
        exclude_contigs_for_methylation_phasing=(
            args.exclude_contigs_for_methylation_phasing.split()
        ),
        output_local_read_phasing_filename=(
            args.output_local_read_phasing or ""
        ),
        output_phasing_error_stats_filename=(
            args.output_phasing_error_stats or ""
        ),
        output_phase_info=args.output_phase_info,
        discard_non_dna_regions=args.discard_non_dna_regions,
        output_sitelist=args.output_sitelist,
        write_run_info=args.write_run_info,
        skip_pileup_image_generation=args.skip_pileup_image_generation,
        logging_every_n_candidates=args.logging_every_n_candidates,
        sample_mean_coverage_on_calling_regions=(
            args.sample_mean_coverage_on_calling_regions
        ),
        filter_low_vaf_candidates=args.filter_low_vaf_candidates,
        low_vaf_threshold=args.low_vaf_threshold,
        low_vaf_max_base_quality=args.low_vaf_max_base_quality,
        low_vaf_max_mapping_quality=args.low_vaf_max_mapping_quality,
        enable_methylation_aware_phasing=(
            args.enable_methylation_aware_phasing
        ),
        normalize_reads=args.normalize_reads,
        enable_methylation_calling=args.enable_methylation_calling,
        methylation_calling_threshold=(
            args.methylation_calling_threshold
        ),
        track_ref_reads=args.track_ref_reads,
        sort_by_haplotypes=args.sort_by_haplotypes,
    )

    # Variant-caller sub-options.
    vco = options.variant_caller_options
    vco.min_count_snps = args.vsc_min_count_snps
    vco.min_count_indels = args.vsc_min_count_indels
    vco.min_fraction_snps = args.vsc_min_fraction_snps
    vco.min_fraction_indels = args.vsc_min_fraction_indels
    vco.min_fraction_multiplier = args.vsc_min_fraction_multiplier
    vco.max_fraction_snps_for_non_target_sample = (
        args.vsc_max_fraction_snps_for_non_target_sample
    )
    vco.max_fraction_indels_for_non_target_sample = (
        args.vsc_max_fraction_indels_for_non_target_sample
    )
    vco.min_indel_fraction_for_small_indels = (
        args.vsc_min_indel_fraction_for_small_indels
    )
    vco.min_indel_fraction_for_large_indels = (
        args.vsc_min_indel_fraction_for_large_indels
    )
    vco.small_indel_threshold = args.vsc_small_indel_threshold
    vco.use_rejected_alleles = args.use_rejected_alleles
    vco.p_error = args.p_error
    vco.gq_resolution = args.gvcf_gq_binsize
    vco.sample_name = args.sample_name
    vco.fraction_reference_sites_to_emit = (
        args.training_random_emit_ref_sites
    )
    if args.haploid_contigs:
        vco.haploid_contigs = tuple(
            args.haploid_contigs.replace(",", " ").split()
        )
    if args.par_regions_bed:
        vco.par_regions_bed = args.par_regions_bed

    # Pileup sub-options.
    po = options.pileup_options
    if args.pileup_image_width:
        po.width = args.pileup_image_width
    po.alt_aligned_pileup = args.alt_aligned_pileup
    po.types_to_alt_align = args.types_to_alt_align
    if args.multi_allelic_mode:
        po.multi_allelic_mode = (
            "no_het_alt" if args.multi_allelic_mode == "no_het_alt_images"
            else "add_het_alt"
        )
    po.sort_by_haplotypes = args.sort_by_haplotypes
    po.reverse_haplotypes = args.reverse_haplotypes
    po.sort_by_alt_allele_support = args.sort_by_alt_allele_support
    po.hp_tag_for_assembly_polishing = (
        args.hp_tag_for_assembly_polishing
    )
    if args.add_supporting_other_alt_color:
        # Reference behavior: distinct alpha for other-alt-supporting
        # reads (make_examples_options.py add_supporting_other_alt_color
        # => other_allele_supporting_read_alpha 0.3).
        po.other_allele_supporting_read_alpha = 0.3
    po.use_non_uniform_downsampling = args.use_non_uniform_downsampling
    po.non_uniform_downsampling_threshold = (
        args.non_uniform_downsampling_threshold
    )

    # Realigner sub-options.
    options.realigner_options.ws_config.enable_strict_insertion_filter = (
        args.enable_strict_insertion_filter
    )
    if args.split_skip_reads:
        options.realigner_options.split_skip_reads = True
    options.trim_reads_for_pileup = args.trim_reads_for_pileup
    options.create_complex_alleles = args.create_complex_alleles
    return options


def resolved_options_from_args(args):
    """Fully-resolved options: flag wiring + model preset + channel
    lists + validation. Shared by main() and the fused streaming
    pipeline (run_deepvariant --stream), so a streamed run is
    configured identically to a staged run."""
    options = options_from_args(args)
    if args.model_preset:
        from deepvariant_tpu_torch.make_examples.presets import (
            apply_model_preset,
        )

        apply_model_preset(options, args.model_preset)
    channel_list = args.channel_list
    if not channel_list and args.channels:
        # Legacy --channels: opt channels appended to the base six.
        base = ("read_base,base_quality,mapping_quality,strand,"
                "read_supports_variant,base_differs_from_ref")
        channel_list = base + "," + args.channels
    if channel_list:
        from deepvariant_tpu_torch.make_examples.pileup import (
            CHANNEL_NAME_TO_ENUM,
        )

        if "BASE_CHANNELS" in channel_list:
            # Macro for the six default channels
            # (make_examples_options.py:1081-1084).
            base = ("read_base,base_quality,mapping_quality,strand,"
                    "read_supports_variant,base_differs_from_ref")
            channel_list = channel_list.replace("BASE_CHANNELS", base)

        names = [c.strip() for c in channel_list.split(",")
                 if c.strip()]
        unknown = [c for c in names if c not in CHANNEL_NAME_TO_ENUM]
        if unknown:
            raise SystemExit(
                f"--channel_list: unknown channel(s) {unknown}; "
                f"valid: {sorted(CHANNEL_NAME_TO_ENUM)}"
            )
        options.pileup_options.channels = tuple(
            CHANNEL_NAME_TO_ENUM[c] for c in names
        )
    if args.add_hp_channel:
        from deepvariant_tpu_torch.make_examples.pileup import CH_HAPLOTYPE_TAG

        if CH_HAPLOTYPE_TAG not in options.pileup_options.channels:
            options.pileup_options.channels = tuple(
                options.pileup_options.channels
            ) + (CH_HAPLOTYPE_TAG,)
    if args.use_allele_frequency:
        from deepvariant_tpu_torch.make_examples.pileup import (
            CH_ALLELE_FREQUENCY,
        )

        if not args.population_vcfs:
            raise SystemExit(
                "--use_allele_frequency needs --population_vcfs"
            )
        if CH_ALLELE_FREQUENCY not in options.pileup_options.channels:
            options.pileup_options.channels = tuple(
                options.pileup_options.channels
            ) + (CH_ALLELE_FREQUENCY,)
    if args.mean_coverage_per_sample:
        options.pileup_options.mean_coverage = float(
            args.mean_coverage_per_sample.split(",")[0]
        )
    try:
        check_options_are_valid(options)
    except OptionsError as e:
        raise SystemExit(f"invalid options: {e}")
    return options


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.stream_examples or args.shm_prefix:
        raise SystemExit(
            "--stream_examples/--shm_* drive the reference's "
            "boost::interprocess ring buffer, which this framework "
            "replaces with the fused streaming pipeline "
            "(run_deepvariant --stream / "
            "deepvariant_tpu_torch.parallel.stream_pipeline); "
            "run without these flags."
        )
    options = resolved_options_from_args(args)
    counts = make_examples_runner(
        options,
        runtime_by_region_path=args.runtime_by_region or None,
    )
    print(
        f"make_examples done: {counts['examples']} examples, "
        f"{counts['candidates']} candidates, {counts['gvcfs']} gvcf "
        f"records (task {args.task})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

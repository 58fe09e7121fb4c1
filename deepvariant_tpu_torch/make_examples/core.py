"""Stage 1 orchestration: regions -> reads -> candidates -> examples.

The port's copy of the calling and training modes of one sample of
`deepvariant_tpu.make_examples.core` (the reference's
make_examples_core.py):
  * region partitioning + round-robin task sharding
    (regions_to_process, make_examples_core.py:799-889);
  * per-region pipeline: BAM or CRAM query with reservoir downsampling
    (region_reads_norealign, :2408-2449) -> optional local-assembly
    realignment (:2479) -> allele counting + very-sensitive calling or
    the proposed-VCF importer + gVCF (candidates_in_region, :2832-2990)
    -> exclude and population-AF hooks -> in training mode, the
    labeler (labeler/) and the class downsampling -> one host-painted
    tf.Example or one device-encode plan per (candidate, alt
    combination), labeled in training mode;
  * OutputsWriter: the examples TFRecord (or the example sink), the plan
    sink, the candidates and gVCF TFRecords (or the gVCF sink), and the
    example_info.json data contract (:3755-3774);
  * make_examples_runner main loop (:3481) with per-region runtime
    accounting (runtime_by_region TSV, :2248-2399).

Everything here runs on the host, the pileup painter
(`pileup.PileupEncoder.build_pileup`) included; in plan mode the card
paints the plans and runs the CNN (calling.plan_predictor).
`MakeExamplesOptions` has every field of the JAX package's, so options
print and pickle alike, but an option whose code is not ported yet makes
`refuse_unported_options` raise NotImplementedError, naming the
ROADMAP.md item that brings it: de novo regions; it also refuses the
small-model options that the JAX package accepts and never reads, at
any value but their defaults, and training rows of the small model with
--phase_reads, which crash the JAX package. The small model's gate
(small_model/, host numpy: its CVOs to a TFRecord or a sink, the
candidates it accepts kept from the CNN, partially accepted
multiallelics left with their other alt sets) and its training rows,
CRAM input (io/cram.py), training mode with every labeler and its
`.labeling_metrics.json`, the realigner (realign/), trimmed reads, every
alt-aligned pileup mode, direct read phasing (phasing/direct_phasing.py,
with its padded region, its TSVs and the candidates' phase info), gVCF
records, the proposed, population and exclude VCFs, and the read-side
options run, on the host like the rest of this module: read
normalization (normalize.py), original qualities (OQ), the aux-driven
channels (MM/ML methylation and 6mA, Ultima's tp/t0), methylation
calling (MF/MD and the '.'-alt methylated reference sites),
methylation-aware phasing (MI, phasing/methylation_aware_phasing.py)
and the candidate sweep (candidate_sweep_runner,
partition_by_candidates).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.sharded_files import maybe_sharded_output_path
from deepvariant_tpu_torch.core.types import (
    ContigInfo,
    Range,
    Variant,
    VariantCall,
)
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io.bam import (
    FLAG_REVERSE,
    BamReader,
    ReadBatch,
    ReadRequirements,
)
from deepvariant_tpu_torch.io.cram import CramBatchReader
from deepvariant_tpu_torch.io.fasta import FastaReader
from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter
from deepvariant_tpu_torch.make_examples.allele_counter import (
    AlleleCounter,
    AlleleCounterOptions,
)
from deepvariant_tpu_torch.make_examples.examples_builder import ExamplesBuilder
from deepvariant_tpu_torch.make_examples import pileup
from deepvariant_tpu_torch.make_examples.normalize import (
    normalize_batch_cigars,
)
from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
from deepvariant_tpu_torch.make_examples.variant_caller import (
    DeepVariantCall,
    VariantCallerOptions,
    VerySensitiveCaller,
)
from deepvariant_tpu_torch.phasing.direct_phasing import (
    DirectPhasing,
    DirectPhasingOptions,
)
from deepvariant_tpu_torch.phasing.methylation_aware_phasing import (
    extract_methylated_ref_sites,
    perform_methylation_aware_phasing,
)
from deepvariant_tpu_torch.realign.config import RealignerOptions
from deepvariant_tpu_torch.realign.realigner import Realigner
from deepvariant_tpu_torch.utils.resources import ResourceMonitor

# Defaults from make_examples_options.py:200-215 and Appendix A.
DEFAULT_PARTITION_SIZE = 1000
DEFAULT_MAX_READS_PER_PARTITION = 1500
DEFAULT_RANDOM_SEED = 2101079370
# Candidate-sweep constants (make_examples_core.py:125,134,874).
END_OF_REGION = -1
# Partitions within a shard's sweep output are separated by this
# (make_examples_core.py:127-129).
END_OF_PARTITION = -2
MAX_PARTITION_LEN = 1000000
DEFAULT_CANDIDATES_PER_PARTITION = 200
# Allele phase from read phases (make_examples_core.py:2636-2668).
MIN_DIFF_READS_FOR_ALLELE_PHASE = 3
MAX_NUM_READS_FOR_OPPOSITE_PHASE = 2
# --output_phasing_error_stats TSV columns
# (make_examples_core.py:113-119).
PHASING_ERROR_STATS_OUTPUT_COLUMNS = (
    "region",
    "num_reads_phase_1",
    "num_reads_phase_2",
    "num_reads_phase_0",
    "num_phase_errors",
)


def _phased_genotype_from_counts(phase_1_count: int,
                                 phase_2_count: int) -> int:
    """1/2 when that phase wins by more than
    MIN_DIFF_READS_FOR_ALLELE_PHASE reads with at most
    MAX_NUM_READS_FOR_OPPOSITE_PHASE opposing, else 0
    (_get_phased_genotype_from_counts,
    make_examples_core.py:2636-2668)."""
    if (phase_1_count > phase_2_count
            and phase_1_count - phase_2_count
            > MIN_DIFF_READS_FOR_ALLELE_PHASE
            and phase_2_count <= MAX_NUM_READS_FOR_OPPOSITE_PHASE):
        return 1
    if (phase_2_count > phase_1_count
            and phase_2_count - phase_1_count
            > MIN_DIFF_READS_FOR_ALLELE_PHASE
            and phase_1_count <= MAX_NUM_READS_FOR_OPPOSITE_PHASE):
        return 2
    return 0


@dataclasses.dataclass
class MakeExamplesOptions:
    """Single-sample MakeExamplesOptions equivalent
    (deepvariant.proto:737-1076 essentials)."""

    reads_filename: str = ""
    ref_filename: str = ""
    examples_filename: str = ""
    candidates_filename: str = ""
    gvcf_filename: str = ""
    mode: str = "calling"  # calling | training | candidate_sweep
    regions: Optional[List[str]] = None  # region literals / BED paths
    exclude_regions: Optional[List[str]] = None
    sample_name: str = "default"
    task_id: int = 0
    num_shards: int = 0
    partition_size: int = DEFAULT_PARTITION_SIZE
    max_reads_per_partition: int = DEFAULT_MAX_READS_PER_PARTITION
    max_reads_for_dynamic_bases_per_region: int = 0
    random_seed: int = DEFAULT_RANDOM_SEED
    realigner_enabled: bool = True
    # Direct phasing (PacBio/ONT presets; make_examples_core.py:3042).
    phase_reads: bool = False
    # 5mC Wilcoxon phase completion after DirectPhasing
    # (make_examples_core.py:3046-3072 + methylation_aware_phasing.cc).
    enable_methylation_aware_phasing: bool = False
    # Per-allele methylation stats (MF/MD FORMAT fields;
    # ComputeMethylationStats, variant_calling_multisample.cc:1499).
    enable_methylation_calling: bool = False
    methylation_calling_threshold: float = 0.5
    # Left-align per-read indels before allele counting
    # (--normalize_reads, allelecounter.cc NormalizeAndAdd).
    normalize_reads: bool = False
    sort_by_haplotypes: bool = False
    track_ref_reads: bool = False
    min_mapping_quality: int = 5
    min_base_quality: int = 10
    sequencing_type: int = 0
    include_med_dp: bool = False
    variant_caller_options: VariantCallerOptions = dataclasses.field(
        default_factory=VariantCallerOptions
    )
    pileup_options: PileupOptions = dataclasses.field(
        default_factory=PileupOptions
    )
    realigner_options: RealignerOptions = dataclasses.field(
        default_factory=RealignerOptions
    )
    # vcf_candidate_importer: candidates from a proposed VCF.
    proposed_variants_filename: str = ""
    # Population allele frequencies (allele_frequency channel).
    population_vcf_filenames: Optional[List[str]] = None
    # Small-model short-circuit (run_deepvariant.py:389-417 gating).
    call_small_model_examples: bool = False
    trained_small_model_path: str = ""
    small_model_snp_gq_threshold: float = 25.0
    small_model_indel_gq_threshold: float = 30.0
    small_model_vaf_context_window_size: int = 0
    small_model_cvo_filename: str = ""
    # Training-mode small-model feature rows
    # (--write_small_model_examples, make_examples_core.py:2015-2050).
    write_small_model_examples: bool = False
    small_model_examples_filename: str = ""
    # Training mode.
    truth_variants_filename: str = ""
    confident_regions_filename: str = ""
    labeler_algorithm: str = "haplotype_labeler"
    customized_classes_labeler_classes_list: str = ""
    customized_classes_labeler_info_field_name: str = ""
    # Per-class emission probabilities in training mode
    # (--downsample_classes, make_examples_core.py label downsampling).
    downsample_classes: Optional[List[float]] = None
    # Regions whose labeled variants get denovo_label marking
    # (--denovo_regions; example schema field denovo_label).
    denovo_regions: Optional[List[str]] = None
    # Caller selection (--variant_caller): very_sensitive_caller or
    # vcf_candidate_importer (the latter also needs proposed_variants).
    variant_caller: str = "very_sensitive_caller"
    # Candidate post-filters.
    select_variant_types: Optional[str] = None  # e.g. "snps indels"
    exclude_variants_vcf_filename: str = ""
    exclude_variants_af_threshold: float = 0.05
    # Read-requirement surface (nucleus ReadRequirements flags).
    # --downsample_fraction (make_examples.py:78): keep each read with
    # this probability at read time; 0 disables.
    downsample_fraction: float = 0.0
    # --hts_io_threads: host BGZF inflation pool size (htslib
    # bgzf-threads / samtools -@ analog); 0 = inline decode.
    hts_io_threads: int = 0
    keep_duplicates: bool = False
    keep_secondary_alignments: bool = False
    keep_supplementary_alignments: bool = False
    parse_sam_aux_fields: Optional[bool] = None
    aux_fields_to_keep: Optional[List[str]] = None
    use_original_quality_scores: bool = False
    use_ref_for_cram: bool = True
    # Realignment guards.
    max_read_length_to_realign: int = 500
    # Phasing knobs (make_examples_core.py phase gating).
    min_alleles_to_phase: int = 1
    phase_max_candidates: int = 5000
    # Percent of region length added on each side for the phasing
    # candidate sweep (PHASE_READS_REGION_PADDING_PCT,
    # dv_constants.py:202).
    phase_reads_region_padding_pct: int = 20
    exclude_contigs_for_methylation_phasing: List[str] = dataclasses.field(
        default_factory=lambda: ["chrX", "chrY"]
    )
    output_local_read_phasing_filename: str = ""
    # Region hygiene / outputs.
    discard_non_dna_regions: bool = False
    output_sitelist: bool = False
    write_run_info: bool = True
    skip_pileup_image_generation: bool = False
    logging_every_n_candidates: int = 2000
    # Mean coverage sampled from the BAM over calling regions
    # (--sample_mean_coverage_on_calling_regions).
    sample_mean_coverage_on_calling_regions: bool = False
    # Small-model extras.
    small_model_call_multiallelics: bool = True
    small_model_emit_all_candidates: bool = False
    small_model_inference_batch_size: int = 128
    # Multisample-oriented switches carried on the options surface.
    enable_joint_realignment: bool = False
    assign_phase_from_normal: bool = False
    # Low-VAF candidate filter (somatic pipelines;
    # make_examples_core.py:1656-1711).
    filter_low_vaf_candidates: bool = False
    low_vaf_threshold: float = 0.05
    low_vaf_max_base_quality: int = 30
    low_vaf_max_mapping_quality: int = 30
    # Trim reads to the pileup alignment region before imaging
    # (--trim_reads_for_pileup; always on for alt alignment).
    trim_reads_for_pileup: bool = False
    # Merge adjacent SNP+indel evidence into complex alleles
    # (--create_complex_alleles, variant_calling_multisample.cc
    # complex-allele construction).
    create_complex_alleles: bool = False
    # Phasing outputs.
    output_phasing_error_stats_filename: str = ""
    output_phase_info: bool = False
    output_debug_info: bool = False


# Common problematic human decoy/unplaced contigs skipped by default
# (reference exclude_contigs.py EXCLUDED_HUMAN_CONTIGS: standard
# hs37d5 / GRCh38 accession names).
EXCLUDED_HUMAN_CONTIGS = [
    "GL000207.1", "GL000226.1", "GL000229.1", "GL000231.1",
    "GL000210.1", "GL000239.1", "GL000235.1", "GL000201.1",
    "GL000247.1", "GL000245.1", "GL000197.1", "GL000203.1",
    "GL000246.1", "GL000249.1", "GL000196.1", "GL000248.1",
    "GL000244.1", "GL000238.1", "GL000202.1", "GL000234.1",
    "GL000232.1", "GL000206.1", "GL000240.1", "GL000236.1",
    "GL000241.1", "GL000243.1", "GL000242.1", "GL000230.1",
    "GL000237.1", "GL000233.1", "GL000204.1", "GL000198.1",
    "GL000208.1", "GL000191.1", "GL000227.1", "GL000228.1",
    "GL000214.1", "GL000221.1", "GL000209.1", "GL000218.1",
    "GL000220.1", "GL000213.1", "GL000211.1", "GL000199.1",
    "GL000217.1", "GL000216.1", "GL000215.1", "GL000205.1",
    "GL000219.1", "GL000224.1", "GL000223.1", "GL000195.1",
    "GL000212.1", "GL000222.1", "GL000200.1", "GL000193.1",
    "GL000194.1", "GL000225.1", "GL000192.1", "NC_007605",
    "hs37d5", "chrEBV",
]


def common_contigs(contigs_list):
    """Contigs present (same name + length) in every list
    (make_examples_core.py:584-620)."""
    if not contigs_list:
        return []
    common = list(contigs_list[0])
    for other in contigs_list[1:]:
        by_name = {c.name: c for c in other}
        common = [
            c for c in common
            if c.name in by_name and by_name[c.name].n_bases == c.n_bases
        ]
    return common


def ensure_consistent_contigs(
    ref_contigs,
    sam_contigs,
    vcf_contig_names=None,
    exclude_contig_names=EXCLUDED_HUMAN_CONTIGS,
    min_coverage_fraction: float = 0.9,
):
    """Common contigs across inputs with an overlap sanity check
    (_ensure_consistent_contigs, make_examples_core.py:540-581;
    min_shared_contigs_basepairs default 0.9). Catches ref/BAM
    mismatches like chr-prefix differences early, with a readable
    error instead of an empty run."""
    if exclude_contig_names:
        excluded = set(exclude_contig_names)
        ref_contigs = [
            c for c in ref_contigs if c.name not in excluded
        ]
    contigs = common_contigs([ref_contigs, list(sam_contigs)])
    if vcf_contig_names:
        names = set(vcf_contig_names)
        contigs = [c for c in contigs if c.name in names]
    ref_bp = sum(c.n_bases for c in ref_contigs) or 1
    common_bp = sum(c.n_bases for c in contigs)
    coverage = common_bp / ref_bp
    if not contigs or coverage < min_coverage_fraction:
        matches = ", ".join(
            f'"{c.name}" ({c.n_bases} bp) '
            + ("matched" if any(
                s.name == c.name for s in contigs
            ) else "IS MISSING")
            for c in ref_contigs[:30]
        )
        raise ValueError(
            f"Reference contigs span {ref_bp} bases but only "
            f"{common_bp} bases ({coverage:.2%}) were found in common "
            "among the input files. Check that the reference and "
            "reads (and truth VCF) use the same genome build (watch "
            f"for chr-prefix differences). Contig matches: {matches}"
        )
    return contigs


def regions_to_process(
    contigs: Sequence[ContigInfo],
    partition_size: int,
    calling_regions: Optional[RangeSet] = None,
    task_id: Optional[int] = None,
    num_shards: Optional[int] = None,
) -> List[Range]:
    """Chop the calling space into fixed-size windows, keeping this task's
    round-robin share when sharded (behavior of make_examples_core.py:799-889).
    """
    if (task_id is None) != (num_shards is None):
        raise ValueError(
            f"sharding requires a task_id / num_shards pair; got "
            f"task_id={task_id}, num_shards={num_shards}"
        )
    if num_shards:
        if num_shards < 0:
            raise ValueError(f"negative shard count: {num_shards}")
        if not 0 <= task_id < num_shards:
            raise ValueError(
                f"task_id {task_id} is outside [0, {num_shards})"
            )
    regions = RangeSet.from_contigs(contigs)
    if calling_regions:
        regions = regions.intersection(calling_regions)
    windows = list(regions.partition(partition_size))
    return windows[task_id::num_shards] if num_shards else windows


# Minimum length of a reference N-run excluded by
# --discard_non_dna_regions (make_examples_core.py:137).
MIN_NON_DNA_REGION = 300_000


def find_ref_n_regions(ref_reader, min_region_len: int) -> List[Range]:
    """Reference runs of non-ACGT bases at least `min_region_len` long
    (make_examples_core.py:675-711), found with a vectorized run-length
    scan per contig instead of the reference's strided byte walk."""
    out: List[Range] = []
    for contig in ref_reader.contigs:
        bases = ref_reader.bases(Range(contig.name, 0, contig.n_bases))
        bases = np.frombuffer(
            bases.encode() if isinstance(bases, str) else
            np.ascontiguousarray(bases).tobytes(),
            np.uint8,
        )
        non_dna = ~(
            (bases == ord("A")) | (bases == ord("C"))
            | (bases == ord("G")) | (bases == ord("T"))
        )
        edges = np.flatnonzero(np.diff(non_dna.astype(np.int8)))
        bounds = np.concatenate(([0], edges + 1, [len(bases)]))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if non_dna[lo] and hi - lo >= min_region_len:
                out.append(Range(contig.name, int(lo), int(hi)))
    return out


def fetch_vcf_positions(
    vcf_paths: Sequence[str],
    contigs: Sequence[ContigInfo],
    calling_regions: Optional[RangeSet],
) -> List[Range]:
    """Positions of variants inside the calling space
    (make_examples_core.py:891-920)."""
    regions = RangeSet.from_contigs(contigs)
    if calling_regions:
        regions = regions.intersection(calling_regions)
    positions: List[Range] = []
    from deepvariant_tpu_torch.io.vcf import VcfReader

    for path in vcf_paths:
        reader = VcfReader(path)
        for region in regions:
            for variant in reader.query(region):
                positions.append(Range(
                    variant.reference_name, variant.start, variant.end
                ))
    return positions


def filter_regions_by_vcf(
    regions: Sequence[Range], variant_positions: Sequence[Range]
) -> List[Range]:
    """Keep only regions containing at least one variant START
    (make_examples_core.py:923-972; a variant spanning several regions
    belongs to the one containing its start), preserving input order.
    Vectorized: per-contig searchsorted over sorted variant starts."""
    starts_by_chrom: Dict[str, np.ndarray] = {}
    for chrom in {v.reference_name for v in variant_positions}:
        starts_by_chrom[chrom] = np.sort(np.array(
            [v.start for v in variant_positions
             if v.reference_name == chrom],
            dtype=np.int64,
        ))
    out = []
    for region in regions:
        starts = starts_by_chrom.get(region.reference_name)
        if starts is None:
            continue
        lo = np.searchsorted(starts, region.start, side="left")
        hi = np.searchsorted(starts, region.end, side="left")
        if hi > lo:
            out.append(region)
    return out


def partition_by_candidates(
    regions: Iterator[Range] | Sequence[Range],
    candidate_positions: Sequence[int],
    max_size: int,
) -> List[Range]:
    """Candidate-balanced partitioning (make_examples_core.py:714-797):
    each partition holds at most `max_size` candidates and at most
    MAX_PARTITION_LEN bp; per-region candidate runs end with the
    END_OF_REGION sentinel."""
    if max_size <= 0:
        raise ValueError(f"partition capacity must be positive, got {max_size}")

    positions = np.asarray(candidate_positions, dtype=np.int64)
    sentinels = np.flatnonzero(positions == END_OF_REGION)
    regions = list(regions)
    if len(sentinels) < len(regions):
        raise ValueError(
            f"candidate sweep stream is truncated: {len(sentinels)} region "
            f"terminators for {len(regions)} regions"
        )

    out: List[Range] = []

    def emit(refname: str, lo: int, hi: int) -> None:
        # Every emitted window is additionally capped at MAX_PARTITION_LEN bp.
        for chunk in range(lo, hi, MAX_PARTITION_LEN):
            out.append(Range(refname, chunk, min(hi, chunk + MAX_PARTITION_LEN)))

    run_start = 0
    for region, s_idx in zip(regions, sentinels):
        run = positions[run_start:s_idx]
        run_start = s_idx + 1
        if run.size and not (
            (run >= region.start) & (run < region.end)
        ).all():
            raise ValueError(
                f"sweep positions fall outside their region {region}: the "
                "sweep output does not correspond to these regions"
            )
        win_lo = win_hi = region.start
        count = 0
        for pos in run.tolist():
            if count == max_size or win_hi - win_lo >= MAX_PARTITION_LEN:
                emit(region.reference_name, win_lo, win_hi)
                # The window that triggered the flush is closed; the fresh
                # window opens at its end with a one-base seed, and this
                # candidate is absorbed uncounted (wire-format compatible
                # with the sweep goldens).
                win_lo, win_hi, count = win_hi, win_hi + 1, 0
            else:
                win_hi = pos + 1
                count += 1
        emit(region.reference_name, win_lo, region.end)
    return out


def reservoir_sample_indices(
    n: int, k: int, rng: np.random.RandomState
) -> np.ndarray:
    """Classic reservoir sampling of k of n indices, preserving order."""
    if n <= k:
        return np.arange(n)
    reservoir = list(range(k))
    for i in range(k, n):
        j = rng.randint(0, i + 1)
        if j < k:
            reservoir[j] = i
    return np.array(sorted(reservoir), dtype=np.int64)


_QUEUE = "ROADMAP.md Queue 1 item 3"
# The small-model options the JAX package accepts and reads nowhere
# (its gate is built without them, deepvariant_tpu/make_examples/
# core.py:705-711), with the only
# value the port takes.
UNREAD_SMALL_MODEL_OPTIONS = {
    "small_model_call_multiallelics": True,
    "small_model_emit_all_candidates": False,
    "small_model_inference_batch_size": 128,
}


def refuse_unported_options(options: "MakeExamplesOptions") -> None:
    """Raise NotImplementedError for every option whose code the port
    does not have yet. Nothing is accepted and then ignored: a run either
    does what its options say or does not start."""
    o = options

    def refuse(what: str, item: str, queue: str = _QUEUE) -> None:
        raise NotImplementedError(
            f"{what} is not ported yet; {queue} ({item})")

    for name, default in UNREAD_SMALL_MODEL_OPTIONS.items():
        if getattr(o, name) != default:
            # Nothing accepted and then ignored.
            raise NotImplementedError(
                f"{name}={getattr(o, name)!r}: the JAX package accepts "
                f"this option and reads it nowhere, so the port runs only "
                f"its default {default!r}; ROADMAP.md Queue 3 (unread "
                "small-model options)")
    if o.write_small_model_examples and o.phase_reads:
        # The JAX package encodes the haplotype copies of a training row
        # without the reads' phases and raises IndexError.
        raise NotImplementedError(
            "--write_small_model_examples with --phase_reads crashes the "
            "JAX package (IndexError) and is refused; ROADMAP.md Queue 3 "
            "(small-model training rows with --phase_reads)")
    if o.denovo_regions:
        # The JAX package accepts --denovo_regions and reads it nowhere:
        # no denovo_label is ever written.
        raise NotImplementedError(
            "de novo regions (--denovo_regions, the examples' "
            "denovo_label) are written by neither package; "
            f"{_QUEUE} (de novo labels)")


@dataclasses.dataclass
class RegionOutputs:
    region: Range
    candidates: List[DeepVariantCall]
    examples: List[bytes]
    gvcfs: List[Variant]
    runtimes: Dict[str, float]
    small_model_cvos: List = dataclasses.field(default_factory=list)
    small_model_examples: List[bytes] = dataclasses.field(
        default_factory=list
    )
    # Device-encode payloads (PlannedExample) when the processor runs
    # in plan mode (fused streaming with on-device pileup painting);
    # `examples` stays empty in that mode.
    plans: List = dataclasses.field(default_factory=list)


class RegionProcessor:
    """Per-region pipeline (make_examples_core.py:1418)."""

    def __init__(self, options: MakeExamplesOptions):
        refuse_unported_options(options)
        self.options = options
        # Count of regions processed; the region half of PS_CONTIG
        # (make_examples_core.py:1465,2254).
        self.region_number = 0
        # --output_phasing_error_stats / --output_local_read_phasing
        # rows, flushed by make_examples_runner.
        self.phasing_error_stats_rows: List[dict] = []
        self.read_phase_rows: List[tuple] = []
        self.ref_reader = FastaReader(options.ref_filename)
        requirements = ReadRequirements(
            min_mapping_quality=options.min_mapping_quality,
            keep_duplicates=options.keep_duplicates,
            keep_secondary_alignments=options.keep_secondary_alignments,
            keep_supplementary_alignments=(
                options.keep_supplementary_alignments
            ),
        )
        if not options.reads_filename:
            self.bam_reader = None
        elif options.reads_filename.endswith(".cram"):
            # --use_ref_for_cram is parsed and changes nothing, as in
            # the JAX package: a slice that embeds its reference is
            # decoded against it, one that does not against --ref.
            self.bam_reader = CramBatchReader(
                options.reads_filename,
                ref_reader=self.ref_reader,
                requirements=requirements,
                downsample_fraction=options.downsample_fraction,
                random_seed=options.random_seed,
            )
        else:
            self.bam_reader = BamReader(
                options.reads_filename, requirements=requirements,
                downsample_fraction=options.downsample_fraction,
                random_seed=options.random_seed,
                io_threads=options.hts_io_threads,
            )
        if options.sort_by_haplotypes:
            options.pileup_options.sort_by_haplotypes = True
        # The CLI-level read requirements funnel into the pileup
        # encoder's per-read checks, exactly as the reference threads
        # one ReadRequirements into pic_options
        # (make_examples_options.py:957-968 -> pileup_image
        # default_options(read_requirements)): EncodeRead's mapq bail
        # and the call-site base-quality bail both read the FLAG
        # values (defaults 5 / 10), not pileup_image.py's standalone
        # defaults.
        options.pileup_options.min_mapping_quality = (
            options.min_mapping_quality
        )
        options.pileup_options.min_base_quality = (
            options.min_base_quality
        )
        if options.small_model_vaf_context_window_size != \
                options.variant_caller_options \
                .small_model_vaf_context_window_size:
            # The caller populates the per-candidate context-VAF map
            # (variant_calling_multisample.cc:1160-1164).
            options.variant_caller_options = dataclasses.replace(
                options.variant_caller_options,
                small_model_vaf_context_window_size=(
                    options.small_model_vaf_context_window_size
                ),
            )
        if options.proposed_variants_filename:
            from deepvariant_tpu_torch.make_examples.vcf_candidate_importer \
                import VcfCandidateImporter

            self.caller = VcfCandidateImporter(
                options.variant_caller_options,
                options.proposed_variants_filename,
            )
        else:
            if options.create_complex_alleles:
                # --create_complex_alleles feeds the caller-level flag
                # (make_examples_core.py:243).
                options.variant_caller_options = dataclasses.replace(
                    options.variant_caller_options,
                    create_complex_alleles=True,
                )
            self.caller = VerySensitiveCaller(
                options.variant_caller_options
            )
        self.examples_builder = ExamplesBuilder(
            self.ref_reader,
            options.pileup_options,
            sequencing_type=options.sequencing_type,
            trim_reads_for_pileup=options.trim_reads_for_pileup,
        )
        self.realigner = Realigner(
            options.realigner_options, self.ref_reader
        ) if options.realigner_enabled else None
        # Fused-stream device encoding: emit PlannedExample payloads
        # (row tensors) instead of host-painted images; set by
        # make_examples_runner(plan_sink=...).
        self.plan_mode = False
        # Fused-stream gVCF: compute ref blocks even with no gvcf
        # TFRecord (records flow to the stream gvcf_sink instead).
        self.force_gvcfs = False
        # Training mode: the labeler (set by make_examples_runner) and
        # the --downsample_classes draws.
        self.labeler = None
        self._downsample_rng = np.random.RandomState(options.random_seed)
        # --select_variant_types filter set (make_examples_core.py
        # select_variants_types semantics): names among
        # {snps, indels, multi-allelics, all}.
        self._select_variant_types = None
        if options.select_variant_types:
            names = set(options.select_variant_types.split())
            if "all" not in names:
                self._select_variant_types = names
        # --exclude_variants_vcf_filename: drop candidates whose site
        # appears in this VCF with AF above the threshold.
        self._exclude_variants_reader = None
        if options.exclude_variants_vcf_filename:
            from deepvariant_tpu_torch.io.vcf import VcfReader

            self._exclude_variants_reader = VcfReader(
                options.exclude_variants_vcf_filename
            )
        self.small_model_caller = None
        self.small_model_factory = None
        if options.write_small_model_examples or \
                options.call_small_model_examples:
            from deepvariant_tpu_torch.small_model.features import (
                SmallModelExampleFactory,
            )

            self.small_model_factory = SmallModelExampleFactory(
                vaf_context_window_size=(
                    options.small_model_vaf_context_window_size
                ),
                expand_by_haplotype=options.phase_reads,
            )
        if options.call_small_model_examples:
            from deepvariant_tpu_torch.small_model.model import (
                SmallModelVariantCaller,
                create_small_model,
                load_bundle,
            )

            n_features = len(
                self.small_model_factory.model_feature_names()
            )
            # Without a trained model the gate runs this seeded numpy
            # init, as the JAX package's does.
            model, variables = create_small_model(n_features)
            feature_mean = feature_scale = None
            if options.trained_small_model_path:
                variables, feature_mean, feature_scale = load_bundle(
                    options.trained_small_model_path, n_features,
                    variables)
            self.small_model_caller = SmallModelVariantCaller(
                model, variables,
                snp_gq_threshold=options.small_model_snp_gq_threshold,
                indel_gq_threshold=(
                    options.small_model_indel_gq_threshold
                ),
            )
            self.small_model_caller.feature_mean = feature_mean
            self.small_model_caller.feature_scale = feature_scale
        self.population_vcf_readers = None
        if options.population_vcf_filenames:
            from deepvariant_tpu_torch.make_examples.allele_frequency import (
                make_population_vcf_readers,
            )

            self.population_vcf_readers = make_population_vcf_readers(
                options.population_vcf_filenames
            )

    # -- reads --------------------------------------------------------------

    def region_reads(self, region: Range) -> ReadBatch:
        """Query + reservoir downsample (:2408-2449)."""
        batch = self.bam_reader.query(region)
        if self.options.use_original_quality_scores:
            self.bam_reader.apply_original_quality_scores(batch)
        # Channel-driven aux decoding: only pay for MM/ML or Ultima
        # flow-tag parsing when a configured channel consumes them.
        chans = set(self.options.pileup_options.channels)
        keep = set(self.options.aux_fields_to_keep or [])
        if self.options.parse_sam_aux_fields:
            # Eager aux parsing (--parse_sam_aux_fields): decode the
            # kept tags now instead of on demand.
            if "HP" in keep or not keep:
                self.bam_reader.parse_hp_tags(batch)
        elif self.options.output_phasing_error_stats_filename:
            # --output_phasing_error_stats compares assigned phases to
            # the input HP tags, so HP is parsed even without
            # --parse_sam_aux_fields (make_examples_core.py:309-313).
            self.bam_reader.parse_hp_tags(batch)
        if (chans & {pileup.CH_BASE_METHYLATION, pileup.CH_BASE_6MA}
                or self.options.enable_methylation_calling
                or (self.options.parse_sam_aux_fields
                    and keep & {"MM", "ML"})):
            self.bam_reader.parse_methylation(batch)
        if chans & {pileup.CH_HOMOPOLYMER_INSERTION_QUALITY,
                    pileup.CH_HOMOPOLYMER_DELETION_QUALITY,
                    pileup.CH_INTER_HOMOPOLYMER_INSERTION_QUALITY}:
            self.bam_reader.parse_ultima_tags(batch)
        n = len(batch)
        if self.options.max_reads_per_partition > 0 and \
                n > self.options.max_reads_per_partition:
            rng = np.random.RandomState(self.options.random_seed)
            keep = reservoir_sample_indices(
                n, self.options.max_reads_per_partition, rng
            )
            batch = batch.subset(keep)
        return batch

    def realign_region_reads(
        self, batch: ReadBatch, region: Range
    ) -> ReadBatch:
        if self.realigner is None or len(batch) == 0:
            return batch
        reads = batch.to_reads()
        # Reads longer than --max_read_length_to_realign keep their
        # original alignment (make_examples_options.py:236-244).
        cap = self.options.max_read_length_to_realign
        if cap > 0:
            long_reads = [
                r for r in reads if len(r.aligned_sequence) > cap
            ]
            reads = [r for r in reads if len(r.aligned_sequence) <= cap]
        else:
            long_reads = []
        _, realigned = self.realigner.realign_reads(
            reads, region, batch=batch if not long_reads else None
        )
        return ReadBatch.from_reads(
            list(realigned) + long_reads, [region.reference_name]
        )

    # -- candidates ---------------------------------------------------------

    def _allele_counter(self, region: Range) -> AlleleCounter:
        ref_bases = self.ref_reader.bases(region)
        prev = "N"
        if region.start > 0:
            prev = self.ref_reader.query(
                Range(region.reference_name, region.start - 1, region.start)
            )
        # Reference tail for deletions anchored at the region edge that
        # extend past region.end (bounded by the contig end; 1 kb covers
        # any deletion a partition-assigned read can carry).
        contig_len = self.ref_reader.contig_length(region.reference_name)
        tail_end = min(contig_len, region.end + 1000)
        after = (
            self.ref_reader.bases(
                Range(region.reference_name, region.end, tail_end)
            )
            if tail_end > region.end else None
        )
        return AlleleCounter(
            ref_bases,
            region,
            AlleleCounterOptions(
                min_base_quality=self.options.min_base_quality,
                min_mapping_quality=self.options.min_mapping_quality,
                track_ref_reads=self.options.track_ref_reads,
            ),
            ref_prev_base=prev,
            ref_bases_after=after,
        )

    def candidates_in_region(
        self, region: Range, batch: ReadBatch, include_gvcfs: bool,
        left_padding: int = 0, right_padding: int = 0,
    ) -> Tuple[List[DeepVariantCall], List[Variant], AlleleCounter]:
        """Candidates + gvcf over `region`; when region is the
        phasing-padded expansion, left/right_padding crop the gvcf back
        to the unpadded partition (candidates stay padded and are
        filtered after phasing; make_examples_core.py:2877,2961-2963)."""
        counter = self._allele_counter(region)
        if self.options.normalize_reads and len(batch):
            # Rewrites the batch's CIGARs and starts in place, before
            # counting: the planners and the painter see the
            # normalized reads too (make_examples_core.py:2903-2936).
            normalize_batch_cigars(batch, counter.ref, region.start)
        counter.add_batch(batch)
        candidates = self.caller.calls_in_region(counter)
        gvcfs = list(self.caller.make_gvcfs(
            counter, include_med_dp=self.options.include_med_dp,
            left_padding=left_padding, right_padding=right_padding,
        )) if include_gvcfs else []
        return candidates, gvcfs, counter

    def _add_methylation_stats(self, batch, candidates) -> None:
        """FORMAT MF (methylation fraction) + MD (methylated depth)
        per allele, ref first (ComputeMethylationStats,
        variant_calling_multisample.cc:1499-1560). A read is
        methylated at the site when its 5mC probability there clears
        methylation_calling_threshold; reverse-strand reads carry the
        CpG mark one base right (on the G)."""
        if not getattr(batch, "meth", None):
            return
        threshold = self.options.methylation_calling_threshold * 255.0

        def is_methylated(read_idx: int, pos: int) -> bool:
            meth = batch.meth[read_idx]
            if meth is None:
                return False
            if batch.flag[read_idx] & FLAG_REVERSE:
                pos += 1
            off = _ref_to_read_offset(batch, read_idx, pos)
            return off is not None and float(meth[off]) >= threshold

        for candidate in candidates:
            variant = candidate.variant
            mf, md = [], []
            groups = [list(candidate.ref_support)] + [
                list(candidate.allele_support.get(alt, []))
                for alt in variant.alternate_bases
            ]
            for ids in groups:
                n_meth = sum(
                    1 for rid in ids if is_methylated(rid, variant.start)
                )
                mf.append(n_meth / len(ids) if ids else 0.0)
                md.append(n_meth)
            if any(f > 0 for f in mf):
                if not variant.calls:
                    variant.calls.append(VariantCall())
                variant.calls[0].info["MF"] = mf
                variant.calls[0].info["MD"] = md

    # Contigs excluded from methylated-reference-site emission
    # (IsExcludedMethylationContig; X/Y have allosome-specific
    # methylation patterns, variant_calling_multisample.cc:981-1035).
    _METHYLATION_EXCLUDED_CONTIGS = frozenset(
        {"chrX", "chrY", "X", "Y"}
    )

    def _methylated_ref_site_candidates(
        self, batch, region: Range, candidates
    ) -> List["DeepVariantCall"]:
        """Reference-only sites carrying 5mC become '.'-alt candidates
        with MF/MD stats (CallVariant has_methylation path,
        variant_calling_multisample.cc:1019-1118; kNoAltAllele '.',
        GT {-1,-1})."""
        if region.reference_name in self._METHYLATION_EXCLUDED_CONTIGS:
            return []
        if not getattr(batch, "meth", None) or not any(
            m is not None for m in batch.meth
        ):
            if self.bam_reader is not None:
                self.bam_reader.parse_methylation(batch)
            if not getattr(batch, "meth", None):
                return []
        threshold = self.options.methylation_calling_threshold
        sites = extract_methylated_ref_sites(
            batch, region.start, region.end,
            threshold=threshold,
        )
        variant_positions = {c.variant.start for c in candidates}
        out = []
        for site in sites:
            if site.position in variant_positions:
                continue  # not a reference-only site
            ref_base = self.ref_reader.query(Range(
                region.reference_name, site.position,
                site.position + 1,
            ))
            if ref_base not in ("A", "C", "G", "T"):
                continue
            n_meth = sum(
                1 for m in site.levels.values()
                if m >= threshold
            )
            ids = sorted(site.levels)
            variant = Variant(
                reference_name=region.reference_name,
                start=site.position,
                end=site.position + 1,
                reference_bases=ref_base,
                alternate_bases=["."],
                calls=[VariantCall(
                    call_set_name=self.options.sample_name,
                    genotype=[-1, -1],
                )],
            )
            variant.calls[0].info["MF"] = [n_meth / len(ids)] if ids \
                else [0.0]
            variant.calls[0].info["MD"] = [n_meth]
            out.append(DeepVariantCall(
                variant=variant,
                allele_support={},
                ref_support=ids,
            ))
        return out

    def _phase_by_methylation(self, batch, region: Range, candidates,
                              phases: List[int]) -> List[int]:
        """Methylation-aware phasing after DirectPhasing: returns
        `phases` completed from the methylated sites and sets MI, the
        Wilcoxon p-value, on the candidates at sites where the test ran
        (set_mi, make_examples_core.py:3078-3084)."""
        if not batch.meth:
            self.bam_reader.parse_methylation(batch)
        sites = []
        if region.reference_name not in set(
            self.options.exclude_contigs_for_methylation_phasing
        ):
            sites = extract_methylated_ref_sites(
                batch, region.start, region.end
            )
        if not sites:
            return phases
        phases, p_values = perform_methylation_aware_phasing(
            len(batch), phases, sites
        )
        p_by_pos = {
            s.position: p for s, p in zip(sites, p_values) if p > 0
        }
        for candidate in candidates:
            p = p_by_pos.get(candidate.variant.start)
            if p is not None and candidate.variant.calls:
                candidate.variant.calls[0].info["MI"] = [p]
        return phases

    def _add_phasing_to_candidates(
        self, dp, candidates, phases, region: Range
    ) -> int:
        """Attach ALT_PS / PS_CONTIG info to candidate variants
        (add_phasing_to_candidate, make_examples_core.py:2700-2786)."""
        phased_variants = dp.phased_variants()
        # PS_CONTIG = "{task_id}-{region_number}"
        # (make_examples_core.py:2726); the region_number half is the
        # switches-TSV join key for cross-region stitching.
        phase_contig = f"{self.options.task_id}-{self.region_number}"
        pv_index = 0
        n_phased = 0
        for candidate in candidates:
            variant = candidate.variant
            if (pv_index < len(phased_variants)
                    and variant.start
                    == phased_variants[pv_index].position):
                pv = phased_variants[pv_index]
                alt_alleles = ["REF"] + list(variant.alternate_bases)
                phased_genotype = [0] * len(alt_alleles)
                alt_1 = [i for i, a in enumerate(alt_alleles)
                         if a == pv.phase_1_bases]
                alt_2 = [i for i, a in enumerate(alt_alleles)
                         if a == pv.phase_2_bases]
                if alt_1 and alt_2:
                    phased_genotype[alt_1[0]] = 1
                    phased_genotype[alt_2[0]] = 2
                    variant.info["ALT_PS"] = phased_genotype
                    variant.info["PS_CONTIG"] = [phase_contig]
                    variant.info["FIRST_VARIANT_IN_BLOCK"] = [
                        pv.is_first_in_block
                    ]
                    n_phased += 1
                pv_index += 1
            else:
                # Infer allele phases from supporting reads
                # (infer_allele_phase, make_examples_core.py:2670-2699;
                # thresholds _get_phased_genotype_from_counts,
                # :2636-2668 with MIN_DIFF_READS_FOR_ALLELE_PHASE=3,
                # MAX_NUM_READS_FOR_OPPOSITE_PHASE=2).
                alleles = ["REF"] + list(variant.alternate_bases)
                phased_genotype = [0] * len(alleles)
                supports = {"REF": candidate.ref_support}
                supports.update(candidate.allele_support)
                for ai, allele in enumerate(alleles):
                    counts = [0, 0, 0]
                    for rid in supports.get(allele, []):
                        counts[phases[rid]] += 1
                    phased_genotype[ai] = _phased_genotype_from_counts(
                        counts[1], counts[2]
                    )
                variant.info["ALT_PS"] = phased_genotype
                variant.info["PS_CONTIG"] = [phase_contig]
                variant.info["FIRST_VARIANT_IN_BLOCK"] = [False]
        return n_phased

    def find_candidate_positions(self, region: Range) -> List[int]:
        """Candidate start positions in region (CANDIDATE_SWEEP pass;
        make_examples_core.py:2117)."""
        batch = self.region_reads(region)
        candidates, _, _ = self.candidates_in_region(region, batch, False)
        return [c.variant.start for c in candidates]

    # -- main ---------------------------------------------------------------

    @staticmethod
    def _variant_type_name(variant) -> str:
        if len(variant.alternate_bases) > 1:
            return "multi-allelics"
        if len(variant.reference_bases) == 1 and all(
            len(a) == 1 for a in variant.alternate_bases
        ):
            return "snps"
        return "indels"

    def _apply_candidate_filters(self, candidates, batch):
        """--select_variant_types / --exclude_variants_vcf_filename
        candidate post-filters (make_examples_core.py select_variants
        + exclude-variants hooks)."""
        out = candidates
        if self._select_variant_types is not None:
            out = [
                c for c in out
                if self._variant_type_name(c.variant)
                in self._select_variant_types
            ]
        if self._exclude_variants_reader is not None and out:
            threshold = self.options.exclude_variants_af_threshold
            kept = []
            for c in out:
                v = c.variant
                drop = False
                for rec in self._exclude_variants_reader.query(
                    Range(v.reference_name, v.start, v.end)
                ):
                    if rec.start != v.start or \
                            rec.reference_bases != v.reference_bases:
                        continue
                    afs = rec.info.get("AF", [])
                    if any(
                        alt in rec.alternate_bases
                        and float(afs[rec.alternate_bases.index(alt)])
                        >= threshold
                        for alt in v.alternate_bases
                        if afs and alt in rec.alternate_bases
                    ):
                        drop = True
                        break
                if not drop:
                    kept.append(c)
            out = kept
        return out

    def _small_model_context_vafs(self, dv_call) -> Optional[List[int]]:
        """Context VAF features in offset order
        (encode_variant_allele_frequency_at_position,
        make_small_model_examples.py:487-512): candidate map lookups
        at variant.start + offset, 0 where absent."""
        w = self.small_model_factory.vaf_context_window_size \
            if self.small_model_factory else 0
        if not w:
            return None
        half = w // 2
        start = dv_call.variant.start
        m = dv_call.allele_frequency_at_position
        return [m.get(start + o, 0) for o in range(-half, half + 1)]

    def _small_model_gate(self, candidates, batch):
        """(CVOs, candidate indices that skip the CNN, {candidate index:
        the alt-index sets left for the CNN}) from the small model's
        calls (make_examples_core.py:3624-3649 hooks)."""
        rows = []
        row_meta = []
        phases = batch.hp.tolist() if len(batch.hp) == len(batch) \
            else None
        for ci, dv_call in enumerate(candidates):
            ctx = self._small_model_context_vafs(dv_call)
            for alt_indices in self.small_model_factory \
                    .alt_index_sets(dv_call):
                rows.append(self.small_model_factory.encode(
                    dv_call, alt_indices, batch,
                    context_vafs=ctx,
                    read_phases=phases,
                ))
                row_meta.append((ci, dv_call, alt_indices))
        skip_for_cnn: set = set()
        cnn_allowed_sets: Dict[int, List[Tuple[int, ...]]] = {}
        if not rows:
            return [], skip_for_cnn, cnn_allowed_sets
        result = self.small_model_caller.call_variants(
            row_meta, np.stack(rows)
        )
        # Fully-resolved candidates (every alt-index set accepted) skip
        # CNN examples entirely; PARTIALLY accepted multiallelics go to
        # the CNN with only their remaining sets
        # (make_examples_alt_allele_indices semantics,
        # small_model/inference.py:186-193 +
        # make_examples_native.cc:194).
        accepted_by_ci: Dict[int, set] = {}
        for ci, alt_set in result.accepted_sets:
            accepted_by_ci.setdefault(ci, set()).add(alt_set)
        for ci, dv_call in enumerate(candidates):
            got = accepted_by_ci.get(ci)
            if not got:
                continue
            remaining = [
                tuple(s)
                for s in self.small_model_factory.alt_index_sets(dv_call)
                if tuple(s) not in got
            ]
            if not remaining:
                skip_for_cnn.add(ci)
            else:
                cnn_allowed_sets[ci] = remaining
        return result.cvos, skip_for_cnn, cnn_allowed_sets

    def _small_model_training_rows(self, candidates, batch,
                                   labels_by_index) -> List[bytes]:
        """Training rows of the confidently labeled candidates
        (write_small_model_examples_in_region, :2015-2050)."""
        from deepvariant_tpu_torch.small_model.train import (
            encode_training_example,
        )

        out = []
        for idx, dv_call in enumerate(candidates):
            label = labels_by_index.get(idx)
            if label is None or not label.is_confident:
                continue
            ctx = self._small_model_context_vafs(dv_call)
            for alt_indices in self.small_model_factory \
                    .alt_index_sets(dv_call):
                row = self.small_model_factory.encode(
                    dv_call, alt_indices, batch, context_vafs=ctx,
                )
                out.append(encode_training_example(
                    [int(v) for v in row],
                    label.label_for_alt_alleles(list(alt_indices)),
                    ids=[dv_call.variant.reference_name,
                         str(dv_call.variant.start)],
                ))
        return out

    def process(self, region: Range) -> RegionOutputs:
        runtimes: Dict[str, float] = {}
        self.region_number += 1
        t0 = time.perf_counter()
        batch = self.region_reads(region)
        runtimes["get reads"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        batch = self.realign_region_reads(batch, region)
        runtimes["realignment"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        include_gvcfs = bool(self.options.gvcf_filename) \
            or self.force_gvcfs
        # With read phasing on, candidates are called over a region
        # expanded by phase_reads_region_padding_pct so edge reads get
        # phasing evidence from just-outside candidates; the padded
        # candidates are filtered back to the partition after phasing
        # (make_examples_core.py:2308-2325, 3164-3167) and the gvcf is
        # cropped at generation time.
        padded_region = None
        padding_pct = self.options.phase_reads_region_padding_pct
        if self.options.phase_reads and padding_pct > 0:
            pad = int((region.end - region.start) * padding_pct / 100)
            contig_len = self.ref_reader.contig_length(
                region.reference_name
            )
            padded_region = Range(
                region.reference_name,
                max(0, region.start - pad),
                min(contig_len, region.end + pad),
            )
        if padded_region is not None:
            candidates, gvcfs, _ = self.candidates_in_region(
                padded_region, batch, include_gvcfs,
                left_padding=region.start - padded_region.start,
                right_padding=padded_region.end - region.end,
            )
        else:
            candidates, gvcfs, _ = self.candidates_in_region(
                region, batch, include_gvcfs
            )
        if candidates:
            candidates = self._apply_candidate_filters(candidates, batch)
        runtimes["find candidates"] = time.perf_counter() - t0

        if self.population_vcf_readers is not None and candidates:
            # Population AF hook (make_examples_core.py:2380-2389).
            from deepvariant_tpu_torch.make_examples.allele_frequency import (
                add_allele_frequencies_to_candidates,
            )

            candidates = list(add_allele_frequencies_to_candidates(
                candidates,
                self.population_vcf_readers[region.reference_name],
                self.ref_reader,
            ))

        if self.options.enable_methylation_calling and candidates:
            self._add_methylation_stats(batch, candidates)
        methylated_ref_sites: List[DeepVariantCall] = []
        if (self.options.enable_methylation_calling
                or self.options.enable_methylation_aware_phasing):
            methylated_ref_sites = self._methylated_ref_site_candidates(
                batch, region, candidates
            )

        # --phase_max_candidates region gate: skip phasing when the
        # region has absurdly many candidates
        # (make_examples_core.py:3021-3029).
        too_many = bool(self.options.phase_max_candidates) and \
            len(candidates) > self.options.phase_max_candidates
        if self.options.phase_reads and candidates and not too_many:
            t0 = time.perf_counter()
            # --min_alleles_to_phase is the per-read allele threshold
            # inside DirectPhasing (make_examples_options.py:1165-1167),
            # NOT a region gate.
            dp = DirectPhasing(DirectPhasingOptions(
                min_alleles_to_phase=self.options.min_alleles_to_phase,
            ))
            phases = dp.phase_reads(candidates, len(batch))
            if self.options.enable_methylation_aware_phasing:
                phases = self._phase_by_methylation(
                    batch, region, candidates, phases)
            if self.options.output_phasing_error_stats_filename:
                # Compare assigned phases against the input HP tags
                # (make_examples_core.py:3083-3148). batch.hp still
                # holds the original tags here.
                stats = {
                    "region": "%s:%d-%d" % (
                        region.reference_name, region.start, region.end
                    ),
                    "num_phase_errors": 0,
                    "num_reads_phase_0": 0,
                    "num_reads_phase_1": 0,
                    "num_reads_phase_2": 0,
                }
                original_hp = batch.hp
                for rid, read_phase in enumerate(phases):
                    original = int(original_hp[rid]) \
                        if rid < len(original_hp) else 0
                    if (original != read_phase and read_phase != 0
                            and original != 0):
                        stats["num_phase_errors"] += 1
                    stats[f"num_reads_phase_{min(read_phase, 2)}"] += 1
                # A whole-block phase swap is not an error: flip when
                # the error count exceeds half the phased reads
                # (make_examples_core.py:3128-3141).
                n_phased_reads = (stats["num_reads_phase_1"]
                                  + stats["num_reads_phase_2"])
                if stats["num_phase_errors"] > n_phased_reads / 2:
                    stats["num_phase_errors"] = (
                        n_phased_reads - stats["num_phase_errors"]
                    )
                self.phasing_error_stats_rows.append(stats)
            if self.options.output_local_read_phasing_filename:
                # --output_local_read_phasing TSV rows
                # (write_read_phase, make_examples_core.py:1355-1362).
                flags = batch.flag
                for rid, read_phase in enumerate(phases):
                    # Unpaired (single-end / long-read) fragments are
                    # read 0, like paired first-of-pair reads
                    # (sam_reader.cc:785).
                    read_number = 0 if (
                        flags[rid] & 0x40 or not flags[rid] & 0x1
                    ) else 1
                    self.read_phase_rows.append((
                        f"{batch.name[rid]}/{read_number}",
                        int(read_phase), self.region_number,
                    ))
            batch.hp = np.asarray(phases, np.int8)
            if self.options.output_phase_info:
                # ALT_PS/PS_CONTIG candidate info is only attached
                # under --output_phase_info
                # (make_examples_core.py:3126-3128).
                self._add_phasing_to_candidates(
                    dp, candidates, phases, region
                )
            runtimes["phase reads"] = time.perf_counter() - t0
        if padded_region is not None and candidates:
            # Padded-region candidates only contribute phasing
            # evidence; output keeps candidates starting inside the
            # partition (filter_candidates_by_region,
            # make_examples_core.py:2579-2608).
            candidates = [
                c for c in candidates
                if region.start <= c.variant.start < region.end
            ]

        # Small-model short-circuit: candidates whose MLP call clears
        # the GQ threshold emit CVOs directly and skip the CNN.
        small_model_cvos: List = []
        skip_for_cnn: set = set()
        cnn_allowed_sets: Dict[int, List[Tuple[int, ...]]] = {}
        if self.small_model_caller is not None and candidates:
            t0 = time.perf_counter()
            small_model_cvos, skip_for_cnn, cnn_allowed_sets = \
                self._small_model_gate(candidates, batch)
            runtimes["small model calls"] = time.perf_counter() - t0

        # Training mode: label all candidates of the region at once (the
        # haplotype labeler works on variant groups, reference
        # make_examples_core.py label_variants flow).
        labels_by_index: Dict[int, object] = {}
        if self.labeler is not None and candidates:
            labels = list(self.labeler.label_variants(
                [c.variant for c in candidates], region
            ))
            labels_by_index = dict(enumerate(labels))

        small_model_examples: List[bytes] = []
        if (self.options.write_small_model_examples
                and labels_by_index and self.small_model_factory):
            small_model_examples = self._small_model_training_rows(
                candidates, batch, labels_by_index)

        t0 = time.perf_counter()
        examples: List[bytes] = []
        plans: List = []
        build_images = not self.options.skip_pileup_image_generation
        downsample = self.options.downsample_classes
        for idx, dv_call in enumerate(
            candidates if build_images else ()
        ):
            if idx in skip_for_cnn:
                continue
            label = labels_by_index.get(idx)
            if self.options.mode == "training" and (
                label is None or not label.is_confident
            ):
                continue
            if downsample and label is not None:
                # --downsample_classes: per-class emission probability.
                cls = label.label_for_alt_alleles(
                    list(range(len(dv_call.variant.alternate_bases))))
                keep_p = downsample[cls] if cls < len(downsample) else 1.0
                if self._downsample_rng.random_sample() >= keep_p:
                    continue
            label_fn = None
            if label is not None:
                label_fn = (
                    lambda variant, alt_indices, _label=label:
                    _label.label_for_alt_alleles(alt_indices)
                )
            allowed_sets = cnn_allowed_sets.get(idx)
            if self.plan_mode:
                plans.extend(
                    self.examples_builder.build_plans_for_candidate(
                        dv_call, batch, label_fn=label_fn,
                        allowed_alt_index_sets=allowed_sets,
                    )
                )
            else:
                for built in (
                    self.examples_builder.build_examples_for_candidate(
                        dv_call, batch, label_fn=label_fn,
                        allowed_alt_index_sets=allowed_sets,
                    )
                ):
                    examples.append(built.encoded)
        runtimes["make pileup images"] = time.perf_counter() - t0
        # The '.'-alt methylated reference sites go to the candidates
        # TFRecord, not to examples (make_examples_core.py:1481-1482).
        all_candidates = candidates + methylated_ref_sites
        all_candidates.sort(key=lambda c: c.variant.start)
        return RegionOutputs(region, all_candidates, examples, gvcfs,
                             runtimes, small_model_cvos,
                             small_model_examples, plans=plans)


class OutputsWriter:
    """Multiplexed TFRecord writers (make_examples_core.py:1182).

    `example_sink`, when given, receives each serialized tf.Example
    instead of the examples TFRecord: the host-encode stream's
    replacement for the reference's shared-memory example stream
    (stream_examples.h:51). `plan_sink(PlannedExample)` receives each
    device-encode payload; `gvcf_sink(Variant)` receives the reference
    blocks in place of the gVCF TFRecord, and
    `small_model_cvo_sink(CallVariantsOutput)` the small model's CVOs in
    place of their TFRecord.
    """

    def __init__(self, options: MakeExamplesOptions, example_sink=None,
                 plan_sink=None, gvcf_sink=None,
                 small_model_cvo_sink=None):
        task = options.task_id
        self._writers: Dict[str, TFRecordWriter] = {}
        self._example_sink = example_sink
        self._plan_sink = plan_sink
        self._gvcf_sink = gvcf_sink
        self._small_model_cvo_sink = small_model_cvo_sink
        if options.examples_filename:
            self.examples_path = maybe_sharded_output_path(
                options.examples_filename, task
            )
            self._writers["examples"] = TFRecordWriter(self.examples_path)
        if options.candidates_filename:
            self._writers["candidates"] = TFRecordWriter(
                maybe_sharded_output_path(options.candidates_filename, task)
            )
        if options.gvcf_filename:
            self._writers["gvcfs"] = TFRecordWriter(
                maybe_sharded_output_path(options.gvcf_filename, task)
            )
        if options.small_model_examples_filename:
            self._writers["small_model_examples"] = TFRecordWriter(
                maybe_sharded_output_path(
                    options.small_model_examples_filename, task
                )
            )
        if options.small_model_cvo_filename:
            self._writers["small_model_cvos"] = TFRecordWriter(
                maybe_sharded_output_path(
                    options.small_model_cvo_filename, task
                )
            )
        self.counts = {name: 0 for name in
                       ("examples", "candidates", "gvcfs",
                        "small_model_cvos", "small_model_examples")}

    def write_examples(self, *encoded: bytes):
        writer = self._writers.get("examples")
        if writer:
            for buf in encoded:
                writer.write(buf)
                self.counts["examples"] += 1
        elif self._example_sink is not None:
            for buf in encoded:
                self._example_sink(buf)
                self.counts["examples"] += 1

    def write_plans(self, *plans):
        """Device-encode payloads count as examples (they 1:1 replace
        them in the fused stream) and flow to the plan sink."""
        if self._plan_sink is not None:
            for plan in plans:
                self._plan_sink(plan)
                self.counts["examples"] += 1

    def write_candidates(self, *candidates: DeepVariantCall):
        writer = self._writers.get("candidates")
        if writer:
            for c in candidates:
                writer.write(c.variant.encode())
                self.counts["candidates"] += 1

    def write_gvcfs(self, *gvcfs: Variant):
        writer = self._writers.get("gvcfs")
        if writer:
            for v in gvcfs:
                writer.write(v.encode())
                self.counts["gvcfs"] += 1
        elif self._gvcf_sink is not None:
            for v in gvcfs:
                self._gvcf_sink(v)
                self.counts["gvcfs"] += 1

    def write_small_model_examples(self, *examples):
        writer = self._writers.get("small_model_examples")
        if writer:
            for buf in examples:
                writer.write(buf)
                self.counts["small_model_examples"] += 1

    def write_small_model_cvos(self, *cvos):
        writer = self._writers.get("small_model_cvos")
        if writer:
            for cvo in cvos:
                writer.write(cvo.encode())
                self.counts["small_model_cvos"] += 1
        elif self._small_model_cvo_sink is not None:
            for cvo in cvos:
                self._small_model_cvo_sink(cvo)
                self.counts["small_model_cvos"] += 1

    def close(self):
        for writer in self._writers.values():
            writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def calling_regions_from_options(
    options: MakeExamplesOptions, contigs: Sequence[ContigInfo]
) -> Optional[RangeSet]:
    """build_calling_regions (calling_regions_utils.py:47-95): contig
    space intersected with --regions (clipped to contig bounds; bare
    contig names allowed) minus --exclude_regions. None means 'call
    everything' (the unrestricted fast path)."""
    if not options.regions and not options.exclude_regions:
        return None
    regions = RangeSet.from_contigs(contigs)
    if options.regions:
        regions = regions.intersection(
            RangeSet.from_regions(options.regions, contigs)
        )
    if options.exclude_regions:
        regions = regions.exclude_regions(
            RangeSet.from_regions(options.exclude_regions, contigs)
        )
    return regions


DEFAULT_SAMPLE_NAME = "default"  # dv_constants.py:81


def extract_sample_name_from_bam_header(header) -> str:
    """First non-empty @RG SM, else DEFAULT_SAMPLE_NAME
    (make_examples_core.py:470-500 extract_sample_name_from_sam_reader:
    multiple samples use the first; empty/missing falls back)."""
    for name in header.sample_names():
        if name:
            return name
    return DEFAULT_SAMPLE_NAME


def candidate_sweep_runner(
    options: MakeExamplesOptions, output_path: str
) -> int:
    """CANDIDATE_SWEEP mode: write int32 candidate positions (with an
    END_OF_REGION sentinel per calling region) for later
    candidate-balanced sharding (make_examples_core.py:3592-3605)."""
    processor = RegionProcessor(options)
    contigs = processor.ref_reader.contigs
    calling_regions = calling_regions_from_options(options, contigs)
    regions = regions_to_process(
        contigs,
        options.partition_size,
        calling_regions,
        options.task_id if options.num_shards else None,
        options.num_shards if options.num_shards else None,
    )
    positions: List[int] = []
    n = 0
    calling_ends = {
        (r.reference_name, r.end) for r in (calling_regions or [])
    } if calling_regions else {
        (c.name, c.n_bases) for c in contigs
    }
    for region in regions:
        found = processor.find_candidate_positions(region)
        positions.extend(found)
        # End-of-partition separator, then end-of-region when this
        # partition closes a calling region
        # (make_examples_core.py:3592-3605 writer flow).
        positions.append(END_OF_PARTITION)
        if (region.reference_name, region.end) in calling_ends:
            positions.append(END_OF_REGION)
        n += len(found)
    np.asarray(positions, np.int32).tofile(output_path)
    return n


def merge_candidate_positions(
    position_arrays: Sequence[np.ndarray],
) -> np.ndarray:
    """Round-robin merge of per-shard sweep outputs
    (merge_ranges_from_files_sequential, make_examples_core.py:3247):
    shards wrote partitions in round-robin region order, separated by
    END_OF_PARTITION; the merged stream keeps only positions +
    END_OF_REGION markers, globally sorted per contig."""
    out: List[int] = []
    idx = [0] * len(position_arrays)
    if not position_arrays:
        return np.empty(0, np.int32)
    live = sum(1 for a in position_arrays if len(a))
    shard = 0
    while live > 0:
        arr = position_arrays[shard]
        i = idx[shard]
        while i < len(arr):
            val = int(arr[i])
            if val == END_OF_PARTITION:
                i += 1
                if i < len(arr) and int(arr[i]) == END_OF_REGION:
                    out.append(END_OF_REGION)
                    i += 1
                break
            out.append(val)
            i += 1
        idx[shard] = i
        if i >= len(arr):
            live -= 1
        # advance to next shard that still has data
        for step in range(1, len(position_arrays) + 1):
            nxt = (shard + step) % len(position_arrays)
            if idx[nxt] < len(position_arrays[nxt]):
                shard = nxt
                break
        else:
            break
    return np.asarray(out, np.int32)


def load_candidate_positions(paths: Sequence[str]) -> np.ndarray:
    """Load + merge per-shard sweep outputs
    (make_examples_core.py:3322-3334)."""
    arrays = [np.fromfile(p, np.int32) for p in paths]
    return merge_candidate_positions(arrays)


def _ref_to_read_offset(batch, read_idx: int, ref_pos: int):
    """Read offset aligned to ref_pos via the CIGAR (M/=/X only)."""
    co = batch.cigar_offsets
    ops = batch.cigar_ops[co[read_idx] : co[read_idx + 1]]
    lens = batch.cigar_lens[co[read_idx] : co[read_idx + 1]]
    ref_i = int(batch.pos[read_idx])
    read_i = 0
    for op, op_len in zip(ops, lens):
        op_len = int(op_len)
        if op in (1, 8, 9):  # M/=/X
            if ref_i <= ref_pos < ref_i + op_len:
                return read_i + (ref_pos - ref_i)
            ref_i += op_len
            read_i += op_len
        elif op in (2, 5):  # I/S
            read_i += op_len
        elif op in (3, 4):  # D/N
            ref_i += op_len
    return None


def make_examples_runner(
    options: MakeExamplesOptions,
    runtime_by_region_path: Optional[str] = None,
    example_sink=None,
    plan_sink=None,
    gvcf_sink=None,
    small_model_cvo_sink=None,
) -> Dict[str, int]:
    """Main per-shard loop (make_examples_core.py:3481). Returns counts.

    `example_sink(serialized_example)` replaces the examples TFRecord
    for the host-encode stream (leave examples_filename empty).
    `plan_sink(PlannedExample)` receives the device-encode payloads
    instead: the host stops after row planning, and pileup painting then
    runs on the card before the CNN (calling.plan_predictor).
    `gvcf_sink(Variant)` replaces the gVCF TFRecord in fused-stream
    runs, and `small_model_cvo_sink(CallVariantsOutput)` the small
    model's CVO TFRecord."""
    if example_sink is not None and plan_sink is not None:
        raise ValueError("pass example_sink or plan_sink, not both")
    monitor = ResourceMonitor().start()
    processor = RegionProcessor(options)
    if plan_sink is not None:
        if not processor.examples_builder.supports_device_encode():
            o = options.pileup_options
            raise ValueError(
                "this channel/alt-mode configuration is not device-"
                f"encodable (channels {sorted(o.channels)}, "
                f"alt_aligned_pileup {o.alt_aligned_pileup!r}); run "
                "the host-encode stream instead"
            )
        processor.plan_mode = True
    if gvcf_sink is not None and not options.gvcf_filename:
        processor.force_gvcfs = True
    if (options.sample_name == DEFAULT_SAMPLE_NAME
            and processor.bam_reader is not None):
        # No explicit --sample_name: derive it from the BAM's @RG SM
        # (make_examples_core.py:205-211).
        options.sample_name = extract_sample_name_from_bam_header(
            processor.bam_reader.header
        )
        options.variant_caller_options.sample_name = options.sample_name
        processor.caller.options.sample_name = options.sample_name
    if options.mode == "training":
        from deepvariant_tpu_torch.labeler.variant_labeler import (
            make_labeler,
        )

        processor.labeler = make_labeler(options, processor.ref_reader)
    contigs = processor.ref_reader.contigs
    if processor.bam_reader is not None:
        vcf_names = None
        if options.mode == "training" and \
                options.truth_variants_filename:
            from deepvariant_tpu_torch.io.vcf import VcfReader

            vcf_names = [
                c.name for c in VcfReader(
                    options.truth_variants_filename
                ).contigs
            ] or None
        contigs = ensure_consistent_contigs(
            contigs, processor.bam_reader.header.contigs, vcf_names
        )
    calling_regions = calling_regions_from_options(options, contigs)
    if options.discard_non_dna_regions and not options.regions:
        # Exclude long reference N-runs up front
        # (make_examples_core.py:3381-3385; only without explicit
        # --regions, matching the reference gate).
        n_regions = find_ref_n_regions(
            processor.ref_reader, MIN_NON_DNA_REGION
        )
        if n_regions:
            base = calling_regions or RangeSet.from_contigs(contigs)
            calling_regions = base.exclude_regions(RangeSet(n_regions))
    regions = regions_to_process(
        contigs,
        options.partition_size,
        calling_regions,
        options.task_id if options.num_shards else None,
        options.num_shards if options.num_shards else None,
    )
    if (options.mode == "calling"
            and options.proposed_variants_filename):
        # Skip regions without proposed variants
        # (make_examples_core.py:3444-3476): with a
        # vcf_candidate_importer every candidate comes from the VCF,
        # so variant-free regions produce nothing.
        n_before = len(regions)
        regions = filter_regions_by_vcf(
            regions,
            fetch_vcf_positions(
                [options.proposed_variants_filename], contigs,
                calling_regions,
            ),
        )
        logging.info(
            "proposed-variants filter: %d -> %d regions",
            n_before, len(regions),
        )
    if options.sample_mean_coverage_on_calling_regions and \
            processor.bam_reader is not None and regions:
        # Estimate mean coverage by sampling up to 16 regions
        # (--sample_mean_coverage_on_calling_regions).
        sampled = regions[:: max(1, len(regions) // 16)][:16]
        bases = 0
        span = 0
        for r in sampled:
            b = processor.bam_reader.query(r)
            bases += int(b.read_lengths().sum())
            span += r.end - r.start
        if span:
            options.pileup_options.mean_coverage = bases / span
    runtime_rows = []
    sitelist: List[str] = []
    n_candidates_logged = 0
    with OutputsWriter(options, example_sink=example_sink,
                       plan_sink=plan_sink, gvcf_sink=gvcf_sink,
                       small_model_cvo_sink=small_model_cvo_sink) as writer:
        for region in regions:
            outputs = processor.process(region)
            if options.output_sitelist:
                sitelist.extend(
                    f"{c.variant.reference_name}\t{c.variant.start}"
                    f"\t{c.variant.end}"
                    for c in outputs.candidates
                )
            if options.logging_every_n_candidates > 0:
                prev = n_candidates_logged
                n_candidates_logged += len(outputs.candidates)
                if (n_candidates_logged
                        // options.logging_every_n_candidates
                        > prev // options.logging_every_n_candidates):
                    logging.info(
                        "task %d: %d candidates (region %s:%d-%d)",
                        options.task_id, n_candidates_logged,
                        region.reference_name, region.start, region.end,
                    )
            writer.write_examples(*outputs.examples)
            writer.write_plans(*outputs.plans)
            writer.write_candidates(*outputs.candidates)
            writer.write_gvcfs(*outputs.gvcfs)
            writer.write_small_model_cvos(*outputs.small_model_cvos)
            writer.write_small_model_examples(
                *outputs.small_model_examples
            )
            if runtime_by_region_path:
                runtime_rows.append((outputs.region, outputs.runtimes))
        counts = dict(writer.counts)
    if options.examples_filename:
        shape = processor.examples_builder.example_shape()
        example_codec.write_example_info(
            writer.examples_path, shape,
            processor.examples_builder.channel_enums(),
        )
    if runtime_by_region_path:
        _write_runtime_tsv(runtime_by_region_path, runtime_rows)
    if options.output_phasing_error_stats_filename:
        # TSV with the reference's header/column order
        # (PHASING_ERROR_STATS_OUTPUT_COLUMNS,
        # make_examples_core.py:113,1248-1256).
        with open(options.output_phasing_error_stats_filename,
                  "w") as f:
            f.write("\t".join(PHASING_ERROR_STATS_OUTPUT_COLUMNS)
                    + "\n")
            for stats in processor.phasing_error_stats_rows:
                f.write("\t".join(
                    str(stats.get(k, "NA"))
                    for k in PHASING_ERROR_STATS_OUTPUT_COLUMNS
                ) + "\n")
    if options.output_local_read_phasing_filename:
        # TSV (fragment_name, phase, region_order)
        # (READ_PHASES_OUTPUT_COLUMNS,
        # make_examples_core.py:111,1258-1266), one per shard: a
        # 'name@N.tsv' spec resolves to this task's file, as the
        # merge_phased_reads input spec expects.
        with open(maybe_sharded_output_path(
                options.output_local_read_phasing_filename,
                options.task_id), "w") as f:
            f.write("fragment_name\tphase\tregion_order\n")
            for key, read_phase, region_n in processor.read_phase_rows:
                f.write(f"{key}\t{read_phase}\t{region_n}\n")
    # Labeling-metrics sidecar (run_info.labeling_metrics,
    # make_examples_core.py:3734-3740): JSON of summable counts. Only
    # the haplotype-matching labelers keep metrics.
    metrics = getattr(processor.labeler, "metrics", None)
    if metrics is not None and options.examples_filename:
        metrics_path = writer.examples_path + ".labeling_metrics.json"
        with open(metrics_path, "w") as f:
            json.dump(metrics.as_dict(), f, indent=2)
    if options.output_sitelist and options.examples_filename:
        # --output_sitelist: candidate positions next to the examples
        # (make_examples_core.py sitelist output).
        with open(writer.examples_path + ".sitelist.tsv", "w") as f:
            f.write("\n".join(sitelist) + ("\n" if sitelist else ""))
    # Run-info sidecar with resource metrics AND the full serialized
    # options (the reference's MakeExamplesRunInfo carries the options
    # proto; --write_run_info gates it, make_examples_core.py:3715-48).
    if options.write_run_info and options.examples_filename:
        run_info = {
            "counts": counts,
            "resource_metrics": monitor.metrics(),
            "num_regions": len(regions),
            "options": serialize_options(options),
        }
        with open(writer.examples_path + ".run_info.json", "w") as f:
            json.dump(run_info, f, indent=2)
    return counts


class OptionsError(ValueError):
    """An invalid flag/option combination."""


def check_options_are_valid(options: MakeExamplesOptions) -> None:
    """Cross-flag consistency validation (behavioral mirror of
    make_examples_options.py:1386-1539's check_options_are_valid)."""
    def bail(msg: str) -> None:
        raise OptionsError(msg)

    if not options.ref_filename:
        bail("a reference FASTA (--ref) is required")
    if not options.examples_filename:
        bail("an output path (--examples) is required")
    if not options.reads_filename:
        bail("an input BAM/CRAM (--reads) is required")
    if options.variant_caller not in (
        "very_sensitive_caller", "vcf_candidate_importer"
    ):
        bail(f"unknown --variant_caller {options.variant_caller!r}")
    if not 0.0 <= options.downsample_fraction <= 1.0:
        bail("--downsample_fraction must be within [0.0, 1.0]")

    importer = options.variant_caller == "vcf_candidate_importer" or \
        bool(options.proposed_variants_filename)
    if options.mode == "candidate_sweep":
        pass
    elif options.mode == "training":
        if not options.truth_variants_filename:
            bail("training mode needs --truth_variants")
        if not options.confident_regions_filename and not importer:
            bail("training mode needs --confident_regions (optional "
                 "only with vcf_candidate_importer)")
        if options.gvcf_filename:
            bail("gVCF output is a calling-mode feature; drop --gvcf "
                 "in training mode")
        if importer and options.proposed_variants_filename:
            bail("vcf_candidate_importer takes its training candidates "
                 "from --truth_variants; --proposed_variants is a "
                 "calling-mode flag")
    elif options.mode == "calling":
        if options.truth_variants_filename:
            bail("--truth_variants is a training-mode flag")
        if options.variant_caller_options.gq_resolution < 1:
            bail("--gvcf_gq_binsize must be >= 1")
        if options.variant_caller == "vcf_candidate_importer" and \
                not options.proposed_variants_filename:
            bail("vcf_candidate_importer in calling mode needs "
                 "--proposed_variants")
    else:
        bail(f"unknown --mode {options.mode!r}")

    vco = options.variant_caller_options
    size_flags = [
        vco.min_indel_fraction_for_small_indels > 0,
        vco.min_indel_fraction_for_large_indels > 0,
        vco.small_indel_threshold > 0,
    ]
    if any(size_flags) and not all(size_flags):
        bail("the indel-size fraction knobs "
             "(--vsc_min_indel_fraction_for_{small,large}_indels, "
             "--vsc_small_indel_threshold) must be set together")
    if all(size_flags):
        if not 0 < vco.min_indel_fraction_for_small_indels < 1:
            bail("--vsc_min_indel_fraction_for_small_indels must be "
                 "in (0, 1)")
        if not 0 < vco.min_indel_fraction_for_large_indels < 1:
            bail("--vsc_min_indel_fraction_for_large_indels must be "
                 "in (0, 1)")

    mult = vco.min_fraction_multiplier
    if (mult <= 0 or mult > 1.0) and mult != float("inf"):
        bail(f"--vsc_min_fraction_multiplier must be in (0, 1] or inf; "
             f"got {mult}")

    height = options.pileup_options.height
    if not 75 <= height <= 362:
        bail(f"pileup height {height} is outside the CNN's supported "
             "75-362 range")
    if options.pileup_options.width % 2 != 1 or \
            options.pileup_options.width < 3:
        bail(f"pileup width must be odd and >= 3, got "
             f"{options.pileup_options.width}")
    if options.downsample_classes is not None and any(
        not 0.0 <= p <= 1.0 for p in options.downsample_classes
    ):
        bail("--downsample_classes probabilities must be within [0, 1]")
    if options.select_variant_types:
        allowed = {"snps", "indels", "multi-allelics", "all"}
        bad = set(options.select_variant_types.split()) - allowed
        if bad:
            bail(f"--select_variant_types: unknown type(s) {sorted(bad)}; "
                 f"allowed: {sorted(allowed)}")


def serialize_options(options: MakeExamplesOptions) -> dict:
    """JSON-safe dump of the full options tree (the single serialized
    options artifact; equivalent of the reference's options proto in
    MakeExamplesRunInfo)."""

    def convert(value):
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            return {
                f.name: convert(getattr(value, f.name))
                for f in dataclasses.fields(value)
            }
        if isinstance(value, (list, tuple)):
            return [convert(v) for v in value]
        if isinstance(value, (np.integer,)):
            return int(value)
        if isinstance(value, (np.floating,)):
            return float(value)
        if isinstance(value, (str, int, float, bool)) or value is None:
            return value
        return repr(value)

    return convert(options)


def _write_runtime_tsv(path: str, rows) -> None:
    """runtime_by_region TSV (make_examples_core.py:1348 semantics)."""
    columns = ["get reads", "realignment", "find candidates",
               "make pileup images"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("region\t" + "\t".join(columns) + "\ttotal\n")
        for region, runtimes in rows:
            vals = [runtimes.get(c, 0.0) for c in columns]
            f.write(
                region.to_region_string() + "\t"
                + "\t".join(f"{v:.6f}" for v in vals)
                + f"\t{sum(vals):.6f}\n"
            )

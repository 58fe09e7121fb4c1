"""Multi-sample example generation (DeepTrio / DeepSomatic / generic N).

The port's copy of `deepvariant_tpu.make_examples.multisample`, host
code held byte for byte against it: the examples, example_info.json,
candidates and gVCF TFRecords of a trio, a tumour/normal pair (or a
tumour alone) and a read set stacked under a pangenome panel.

Reference parity:
  * samples are an ordered list of SampleOptions with per-sample pileup
    heights; the example image stacks one pileup per sample in order
    (CreateAndWriteExamplesForCandidate, make_examples_native.cc:632;
    trio order [parent1, child, parent2] with MAIN_SAMPLE_INDEX=1,
    deeptrio/make_examples.py:48,229-250; heights 100/100/100 ->
    300-high examples, deeptrio/dt_constants.py);
  * candidates are called on the target sample's allele counts; one
    example set is emitted per sample_role_to_train (child for trio,
    tumor for somatic).

Every sample's plane is painted on the host (`PileupEncoder.build_pileup`),
as in the JAX package; the one-step scripts (scripts/run_deeptrio.py,
run_deepsomatic.py, run_pangenome_aware_deepvariant.py) classify the
stacked examples on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.io.bam import BamReader, ReadBatch, ReadRequirements
from deepvariant_tpu_torch.io.fasta import FastaReader
from deepvariant_tpu_torch.make_examples.core import (
    MakeExamplesOptions,
    RegionOutputs,
    RegionProcessor,
)
from deepvariant_tpu_torch.make_examples.examples_builder import ExamplesBuilder
from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
from deepvariant_tpu_torch.make_examples.variant_caller import DeepVariantCall

# Trio constants (deeptrio/dt_constants.py, deeptrio/make_examples.py:48).
TRIO_MAIN_SAMPLE_INDEX = 1
TRIO_HEIGHT_CHILD = 100
TRIO_HEIGHT_PARENT = 100


@dataclasses.dataclass
class SampleSpec:
    """One sample (deepvariant.proto SampleOptions essentials)."""

    role: str
    reads_filename: str
    sample_name: str = ""
    pileup_height: int = 100
    # Pangenome-panel semantics (make_examples_pangenome_aware_dv.py
    # :239-264 SampleOptions): keep only haplotypes spanning the full
    # example window; blank uninformative channels; optionally blank
    # the whole plane for given variant types ("SNP"/"INDEL").
    keep_only_window_spanning_reads: bool = False
    channels_to_blank: Tuple[int, ...] = ()
    variant_types_to_blank: Tuple[str, ...] = ()
    # Contig-name prefix present in the calling regions but absent in
    # this sample's BAM (SamReader chrom_prefix,
    # make_examples_core.py:1618): "chr" maps chr20 -> 20.
    chrom_prefix: str = ""


def trio_samples(
    reads_child: str, reads_parent1: str, reads_parent2: str,
    sample_name_child: str = "child",
    sample_name_parent1: str = "parent1",
    sample_name_parent2: str = "parent2",
    height_child: int = TRIO_HEIGHT_CHILD,
    height_parent: int = TRIO_HEIGHT_PARENT,
) -> List[SampleSpec]:
    """[parent1, child, parent2] (deeptrio/make_examples.py:229-250).

    Heights default to the dt_constants 100/100/100; the run_deeptrio
    WGS/PacBio presets use child 60 / parent 40 (run_deeptrio.py:392).
    """
    return [
        SampleSpec("parent1", reads_parent1, sample_name_parent1,
                   height_parent),
        SampleSpec("child", reads_child, sample_name_child,
                   height_child),
        SampleSpec("parent2", reads_parent2, sample_name_parent2,
                   height_parent),
    ]


def pangenome_samples(
    reads: str, pangenome: str,
    sample_name_reads: str = "reads",
    sample_name_pangenome: str = "pangenome",
    variant_types_to_blank: Sequence[str] = (),
    keep_only_window_spanning_haplotypes: bool = True,
) -> List[SampleSpec]:
    """[pangenome, reads] with reads as the calling sample
    (make_examples_pangenome_aware_dv.py:285-289 samples_in_order).

    The pangenome panel is a set of haplotype alignments (BAM, or a
    .gbz graph decoded natively by io.gbz.extract_panel_bam — the
    reference's GbzReader/shared-memory loader analog). Haplotype rows
    render with haplotype-tag / diff / base-quality / mapping-quality
    channels blanked (:252-258 channels_enum_to_blank)."""
    from deepvariant_tpu_torch.make_examples.pileup import (
        CH_BASE_QUALITY,
        CH_HAPLOTYPE_TAG,
        CH_MAPPING_QUALITY,
    )

    # Alt-aligned diff channels occupy enum slots 9/10; in plain
    # channel pileups the blanking applies to whichever configured
    # channels match.
    blank = (CH_HAPLOTYPE_TAG, 9, 10, CH_BASE_QUALITY,
             CH_MAPPING_QUALITY)
    return [
        SampleSpec(
            "pangenome", pangenome, sample_name_pangenome, 100,
            keep_only_window_spanning_reads=(
                keep_only_window_spanning_haplotypes
            ),
            channels_to_blank=blank,
            variant_types_to_blank=tuple(
                v.upper() for v in variant_types_to_blank
            ),
        ),
        SampleSpec("reads", reads, sample_name_reads, 100),
    ]


PANGENOME_MAIN_SAMPLE_INDEX = 1


def _variant_type(variant: Variant) -> str:
    if len(variant.reference_bases) == 1 and all(
        len(a) == 1 for a in variant.alternate_bases
    ):
        return "SNP"
    return "INDEL"


def somatic_samples(
    reads_tumor: str, reads_normal: str,
    sample_name_tumor: str = "tumor",
    sample_name_normal: str = "normal",
) -> List[SampleSpec]:
    """[normal, tumor] with tumor as the calling sample
    (make_examples_somatic.py sample ordering)."""
    return [
        SampleSpec("normal", reads_normal, sample_name_normal, 100),
        SampleSpec("tumor", reads_tumor, sample_name_tumor, 100),
    ]


class MultiSampleRegionProcessor:
    """Per-region pipeline over N samples with stacked pileups."""

    def __init__(
        self,
        options: MakeExamplesOptions,
        samples: Sequence[SampleSpec],
        main_sample_index: int,
    ):
        self.options = options
        self.samples = list(samples)
        self.main_sample_index = main_sample_index
        self.ref_reader = FastaReader(options.ref_filename)
        requirements = ReadRequirements(
            min_mapping_quality=options.min_mapping_quality,
        )
        self.readers = [
            BamReader(s.reads_filename, requirements=requirements)
            for s in self.samples
        ]
        # One encoder per sample so each can have its own height.
        self.builders: List[ExamplesBuilder] = []
        for s in self.samples:
            # CLI read requirements funnel into the encoder's per-read
            # checks (same single-ReadRequirements threading as the
            # reference; see RegionProcessor.__init__).
            popts = dataclasses.replace(
                options.pileup_options, height=s.pileup_height,
                min_mapping_quality=options.min_mapping_quality,
                min_base_quality=options.min_base_quality,
            )
            self.builders.append(ExamplesBuilder(
                self.ref_reader, popts,
                sequencing_type=options.sequencing_type,
            ))
        # Borrow the single-sample machinery for reads/candidates. Of
        # RegionProcessor's methods this class calls
        # realign_region_reads, _allele_counter, should_filter_low_vaf
        # and assign_phase_from_normal, which read options, ref_reader
        # and realigner only; none reads region_number, the small
        # model or the CRAM reader that __init__ also sets.
        self._main = RegionProcessor.__new__(RegionProcessor)
        self._main.options = options
        self._main.ref_reader = self.ref_reader
        self._main.bam_reader = self.readers[main_sample_index]
        from deepvariant_tpu_torch.make_examples.variant_caller import (
            VerySensitiveCaller,
        )
        from deepvariant_tpu_torch.realign.realigner import Realigner

        # The target sample's role gates somatic matched-normal fields
        # (variant_calling_multisample.cc:923 target_role_).
        self._main.caller = VerySensitiveCaller(dataclasses.replace(
            options.variant_caller_options,
            target_sample_role=samples[main_sample_index].role,
        ))
        self._main.examples_builder = self.builders[main_sample_index]
        self._main.realigner = Realigner(
            options.realigner_options, self.ref_reader
        ) if options.realigner_enabled else None
        self._main.labeler = None
        # Training mode: label the MAIN sample's candidates with its
        # truth set (deeptrio/make_examples.py: each sample output is
        # labeled against that sample's truth_variants + confident
        # regions; here the main sample of this pass).
        self.labeler = None
        if options.mode == "training" and \
                options.truth_variants_filename:
            from deepvariant_tpu_torch.labeler.variant_labeler import (
                make_labeler,
            )

            self.labeler = make_labeler(options, self.ref_reader)

    def example_shape(self) -> Tuple[int, int, int]:
        h = sum(
            b.example_shape()[0] for b in self.builders
        )
        _, w, c = self.builders[self.main_sample_index].example_shape()
        return (h, w, c)

    def channel_enums(self) -> List[int]:
        return self.builders[self.main_sample_index].channel_enums()

    def process(self, region: Range) -> RegionOutputs:
        runtimes: Dict[str, float] = {}
        t0 = time.perf_counter()
        batches: List[ReadBatch] = []
        for reader, spec in zip(self.readers, self.samples):
            sample_region = region
            if spec.chrom_prefix and region.reference_name.startswith(
                spec.chrom_prefix
            ):
                sample_region = Range(
                    region.reference_name[len(spec.chrom_prefix):],
                    region.start, region.end,
                )
            batches.append(
                self._downsample(reader.query(sample_region))
            )
        runtimes["get reads"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if self._main.realigner is not None:
            batches = [
                self._main.realign_region_reads(b, region) for b in batches
            ]
        runtimes["realignment"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        include_gvcfs = bool(self.options.gvcf_filename)
        main_batch = batches[self.main_sample_index]
        if hasattr(self._main.caller, "select_alt_alleles_multisample"):
            # Pooled-sample candidate calling: the target sample's
            # alleles can be rescued by evidence across all samples
            # (AlleleFilter + min_fraction_multiplier,
            # variant_calling_multisample.cc:264-308).
            counters = []
            for b in batches:
                counter = self._main._allele_counter(region)
                if self.options.normalize_reads and len(b):
                    from deepvariant_tpu_torch.make_examples.normalize import (
                        normalize_batch_cigars,
                    )

                    normalize_batch_cigars(b, counter.ref, region.start)
                counter.add_batch(b)
                counters.append(counter)
            target = counters[self.main_sample_index]
            candidates = self._main.caller.calls_in_region(
                target, context_counters=counters
            )
            gvcfs = list(self._main.caller.make_gvcfs(
                target, include_med_dp=self.options.include_med_dp
            )) if include_gvcfs else []
        else:
            counters = None
            candidates, gvcfs, _ = self._main.candidates_in_region(
                region, main_batch, include_gvcfs
            )
        if candidates and self.options.filter_low_vaf_candidates:
            candidates = [
                c for c in candidates
                if not self._main.should_filter_low_vaf(c, main_batch)
            ]
        runtimes["find candidates"] = time.perf_counter() - t0

        if self.options.phase_reads and counters is not None:
            t0 = time.perf_counter()
            self._phase_sample_reads(batches, counters, candidates)
            runtimes["phase reads"] = time.perf_counter() - t0

        labels_by_index: Dict[int, object] = {}
        if self.labeler is not None and candidates:
            labels = list(self.labeler.label_variants(
                [c.variant for c in candidates], region
            ))
            labels_by_index = dict(enumerate(labels))

        t0 = time.perf_counter()
        examples: List[bytes] = []
        for idx, dv_call in enumerate(candidates):
            label = labels_by_index.get(idx)
            if self.options.mode == "training" and (
                label is None or not label.is_confident
            ):
                continue
            examples.extend(
                self._stacked_examples_for_candidate(
                    dv_call, batches, counters, label=label
                )
            )
        runtimes["make pileup images"] = time.perf_counter() - t0
        return RegionOutputs(region, candidates, examples, gvcfs, runtimes)

    def _phase_sample_reads(self, batches, counters, candidates):
        """Per-sample read phasing (make_examples_core.py:3010-3046):
        each sample's reads phase on its own candidates via
        DirectPhasing; with --assign_phase_from_normal the tumor
        instead inherits phases from the matched normal's phased
        variants (so tumor-only somatic alleles never flip the
        haplotype assignment)."""
        from deepvariant_tpu_torch.phasing.direct_phasing import (
            DirectPhasing,
            DirectPhasingOptions,
        )

        gate = self.options.phase_max_candidates
        normal_dp = None
        for i, spec in enumerate(self.samples):
            batch = batches[i]
            if (spec.role == "tumor"
                    and self.options.assign_phase_from_normal
                    and normal_dp is not None):
                phases = self._main.assign_phase_from_normal(
                    candidates, len(batch),
                    normal_dp.phased_variants(),
                )
            else:
                if i == self.main_sample_index:
                    cands = candidates
                else:
                    cands = self._main.caller.calls_in_region(
                        counters[i]
                    )
                if gate and len(cands) > gate:
                    continue
                dp = DirectPhasing(DirectPhasingOptions(
                    min_alleles_to_phase=(
                        self.options.min_alleles_to_phase
                    ),
                ))
                phases = dp.phase_reads(cands, len(batch))
                if spec.role == "normal":
                    normal_dp = dp
            batch.hp = np.asarray(phases, np.int8)

    def _downsample(self, batch: ReadBatch) -> ReadBatch:
        from deepvariant_tpu_torch.make_examples.core import (
            reservoir_sample_indices,
        )

        n = len(batch)
        limit = self.options.max_reads_per_partition
        if limit > 0 and n > limit:
            rng = np.random.RandomState(self.options.random_seed)
            batch = batch.subset(reservoir_sample_indices(n, limit, rng))
        return batch

    def _stacked_examples_for_candidate(
        self, dv_call: DeepVariantCall, batches: Sequence[ReadBatch],
        counters=None, label=None,
    ) -> List[bytes]:
        """One example per alt combo; image = vertical stack of
        per-sample pileups in sample order."""
        from deepvariant_tpu_torch.io import examples as example_codec
        from deepvariant_tpu_torch.make_examples.examples_builder import (
            alt_allele_combinations,
        )
        from deepvariant_tpu_torch.make_examples.pileup import (
            reads_overlapping_variant,
        )

        variant = dv_call.variant
        main_builder = self.builders[self.main_sample_index]
        ref_window = main_builder.reference_window(variant)
        if ref_window is None or \
                len(ref_window) != self.options.pileup_options.width:
            return []
        alt_index = {a: i for i, a in enumerate(variant.alternate_bases)}
        locus = (
            f"{variant.reference_name}:{variant.start + 1}-{variant.end}"
        )
        out: List[bytes] = []
        for combo in alt_allele_combinations(variant):
            planes = []
            for sample_i, (builder, batch) in enumerate(
                zip(self.builders, batches)
            ):
                if sample_i == self.main_sample_index:
                    call_for_sample = dv_call
                else:
                    # Each sample's reads are colored by THEIR support
                    # for the candidate's alleles (per-sample
                    # AddSupportingReads semantics).
                    support, refs = ({}, [])
                    if counters is not None:
                        support, refs = (
                            self._main.caller.support_from_counter(
                                counters[sample_i], dv_call
                            )
                        )
                    call_for_sample = DeepVariantCall(
                        variant=variant, allele_support=support,
                        ref_support=refs,
                        allele_keys=dv_call.allele_keys,
                    )
                indices = reads_overlapping_variant(
                    batch, variant,
                    builder.pileup_options.read_overlap_buffer_bp,
                )
                spec = self.samples[sample_i]
                if spec.keep_only_window_spanning_reads and len(indices):
                    image_start = variant.start - \
                        builder.pileup_options.half_width
                    image_end = image_start + \
                        builder.pileup_options.width
                    ends = batch.reference_ends()
                    indices = [
                        i for i in indices
                        if batch.pos[i] <= image_start
                        and ends[i] >= image_end
                    ]
                plane = builder.encoder.build_pileup(
                    call_for_sample, ref_window, batch, indices, combo
                )
                if spec.variant_types_to_blank and \
                        _variant_type(variant) in \
                        spec.variant_types_to_blank:
                    plane = np.zeros_like(plane)
                elif spec.channels_to_blank:
                    chans = builder.pileup_options.channels
                    for ci, ch in enumerate(chans):
                        if ch in spec.channels_to_blank:
                            plane[:, :, ci] = 0
                planes.append(plane)
            image = np.concatenate(planes, axis=0)
            indices_sorted = sorted(
                alt_index[a] for a in combo if a in alt_index
            )
            out.append(example_codec.make_example(
                variant, image, indices_sorted, locus,
                sequencing_type=self.options.sequencing_type,
                label=(
                    label.label_for_alt_alleles(indices_sorted)
                    if label is not None else None
                ),
            ))
        return out


def make_multisample_examples_runner(
    options: MakeExamplesOptions,
    samples: Sequence[SampleSpec],
    main_sample_index: int,
) -> Dict[str, int]:
    """Multi-sample analogue of make_examples_runner."""
    from deepvariant_tpu_torch.io import examples as example_codec
    from deepvariant_tpu_torch.make_examples.core import (
        OutputsWriter,
        calling_regions_from_options,
        regions_to_process,
    )

    processor = MultiSampleRegionProcessor(
        options, samples, main_sample_index
    )
    contigs = processor.ref_reader.contigs
    calling_regions = calling_regions_from_options(options, contigs)
    regions = regions_to_process(
        contigs,
        options.partition_size,
        calling_regions,
        options.task_id if options.num_shards else None,
        options.num_shards if options.num_shards else None,
    )
    with OutputsWriter(options) as writer:
        for region in regions:
            outputs = processor.process(region)
            writer.write_examples(*outputs.examples)
            writer.write_candidates(*outputs.candidates)
            writer.write_gvcfs(*outputs.gvcfs)
        counts = dict(writer.counts)
    if options.examples_filename:
        example_codec.write_example_info(
            writer.examples_path,
            processor.example_shape(),
            processor.channel_enums(),
        )
    return counts


def refuse_unread_flags(args, unread: Dict[str, object]) -> None:
    """Raise NotImplementedError for a one-step script's flag that the
    JAX package accepts and reads nowhere, at any value but `unread`'s
    default for it: nothing is accepted and then ignored."""
    for name, default in unread.items():
        value = getattr(args, name)
        if value != default:
            raise NotImplementedError(
                f"--{name}={value!r}: the JAX package accepts this flag "
                "and reads it nowhere, so the port runs only its default "
                f"{default!r}; ROADMAP.md Queue 3 (unread product-driver "
                "options)")

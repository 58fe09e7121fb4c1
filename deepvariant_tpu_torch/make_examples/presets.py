"""Per-product make_examples presets.

The port's copy of `deepvariant_tpu.make_examples.presets`: the calling
flags of each released model type (since v1.10 the reference stores them
in the model's `model.example_info.json`, `flags_for_calling`).
`apply_pileup_preset` sets the `PileupOptions` half (channels,
alt-aligned pileup mode, width, height, haplotype sorting);
`apply_model_preset` sets a whole `MakeExamplesOptions` (that half plus
phasing, realigner, partition sizes, candidate thresholds). Every
preset runs through the port's stage 1 as it is, the long-read presets
with direct read phasing (`phase_reads=True`).

Channel enums (deepvariant.proto:1287-1342): 1-6 the base six,
7 haplotype_tag, 19 insert_size, 26 supplementary_alignment; the two
diff_channels alt-aligned planes are appended by the encoder.
"""

from __future__ import annotations

from deepvariant_tpu_torch.make_examples.core import MakeExamplesOptions
from deepvariant_tpu_torch.make_examples.pileup import PileupOptions

MODEL_TYPES = ("WGS", "WES", "PACBIO", "MASSEQ", "ONT_R104",
               "HYBRID_PACBIO_ILLUMINA", "RNASEQ")


def apply_pileup_preset(options: PileupOptions,
                        model_type: str) -> PileupOptions:
    """Mutates `options` with the model type's pileup flags."""
    model_type = model_type.upper()
    p = options
    if model_type in ("WGS", "WES", "HYBRID_PACBIO_ILLUMINA"):
        # 6 base channels + insert_size.
        p.channels = (1, 2, 3, 4, 5, 6, 19)
    elif model_type in ("PACBIO", "MASSEQ", "ONT_R104"):
        p.channels = (1, 2, 3, 4, 5, 6, 7, 26)
        p.alt_aligned_pileup = "diff_channels"
        p.width = 147
        p.height = 100
        p.sort_by_haplotypes = True
    elif model_type == "RNASEQ":
        p.channels = (1, 2, 3, 4, 5, 6)
    else:
        raise ValueError(f"unknown model type: {model_type}")
    return options


def apply_model_preset(
    options: MakeExamplesOptions, model_type: str
) -> MakeExamplesOptions:
    """Mutates `options` with the model type's calling flags."""
    model_type = model_type.upper()
    apply_pileup_preset(options.pileup_options, model_type)
    if model_type in ("PACBIO", "MASSEQ", "ONT_R104"):
        # deepvariant.pacbio model.example_info.json flags_for_calling.
        options.sort_by_haplotypes = True
        options.phase_reads = True
        options.track_ref_reads = True
        options.realigner_enabled = False
        options.max_reads_per_partition = 600
        options.min_mapping_quality = 5 if model_type == "ONT_R104" else 1
        options.partition_size = 25000
        options.variant_caller_options.min_fraction_indels = 0.12
        if model_type == "ONT_R104":
            options.variant_caller_options.min_fraction_snps = 0.08
    elif model_type == "RNASEQ":
        # RNA-seq case study: split_skip_reads=true splits spliced
        # (N-CIGAR) alignments into per-exon reads before realignment.
        options.realigner_options.split_skip_reads = True
    return options

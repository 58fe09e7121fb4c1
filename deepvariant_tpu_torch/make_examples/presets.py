"""Per-product pileup presets.

The pileup half of `deepvariant_tpu.make_examples.presets`: the
`PileupOptions` fields that each released model type's calling flags set
(channels, alt-aligned pileup mode, width, height, haplotype sorting).
The `MakeExamplesOptions` half (phasing, realigner, partition sizes,
candidate thresholds) waits for the port of the host stages.

Channel enums (deepvariant.proto:1287-1342): 1-6 the base six,
7 haplotype_tag, 19 insert_size, 26 supplementary_alignment; the two
diff_channels alt-aligned planes are appended by the encoder.
"""

from __future__ import annotations

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

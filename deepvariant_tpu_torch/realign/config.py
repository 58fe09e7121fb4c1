"""Realigner option dataclasses with reference defaults.

The port's copy of `deepvariant_tpu.realign.config` (realigner_pb2
options with the flag defaults of reference realigner.py:60-270).
`MakeExamplesOptions` carries these, and the modules beside this one
(window_selector, debruijn_graph, ssw, fast_pass_aligner, realigner)
read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# reference realigner.py:240 (_REF_ALIGN_MARGIN)
REF_ALIGN_MARGIN = 20
# reference realigner.py:266 (_MIN_SPLIT_LEN)
MIN_SPLIT_LEN = 15


@dataclasses.dataclass
class VariantReadsThresholdModel:
    # realigner.py:243-244 defaults
    min_num_supporting_reads: int = 2
    max_num_supporting_reads: int = 300


@dataclasses.dataclass
class AlleleCountLinearModel:
    # realigner.py:245-255 (_ALLELE_COUNT_LINEAR_MODEL_DEFAULT)
    bias: float = -0.683379
    coeff_soft_clip: float = 2.997000
    coeff_substitution: float = -0.086644
    coeff_insertion: float = 2.493585
    coeff_deletion: float = 1.795914
    coeff_reference: float = -0.059787
    decision_boundary: float = 3.0


@dataclasses.dataclass
class WindowSelectorOptions:
    # realigner.py:86-130 flag defaults
    min_mapq: int = 20
    min_base_quality: int = 20
    min_windows_distance: int = 80
    max_window_size: int = 1000
    region_expansion_in_bp: int = 20
    min_allele_support: int = 2  # _MIN_ALLELE_SUPPORT (realigner.py:269)
    enable_strict_insertion_filter: bool = False
    realign_all: bool = False
    keep_legacy_behavior: bool = False
    # model selection: 'variant_reads' (default) | 'allele_count_linear'
    model_type: str = "variant_reads"
    variant_reads_model: VariantReadsThresholdModel = dataclasses.field(
        default_factory=VariantReadsThresholdModel
    )
    allele_count_linear_model: AlleleCountLinearModel = dataclasses.field(
        default_factory=AlleleCountLinearModel
    )


@dataclasses.dataclass
class DeBruijnGraphOptions:
    # realigner.py:131-167 flag defaults
    min_k: int = 10
    max_k: int = 101
    step_k: int = 1
    min_mapq: int = 14
    min_base_quality: int = 15
    min_edge_weight: int = 2
    max_num_paths: int = 256
    disable_graph_pruning: bool = False


@dataclasses.dataclass
class AlignerOptions:
    # realigner.py:168-238 flag defaults
    match: int = 4
    mismatch: int = 6
    gap_open: int = 8
    gap_extend: int = 2
    k: int = 23
    error_rate: float = 0.01
    kmer_size: int = 32  # realigner.py:239 (_KMER_SIZE)
    max_num_of_mismatches: int = 2  # realigner.py:219-223
    realignment_similarity_threshold: float = 0.16934  # realigner.py:224
    read_size: int = 250
    force_alignment: bool = False


@dataclasses.dataclass
class RealignerOptions:
    ws_config: WindowSelectorOptions = dataclasses.field(
        default_factory=WindowSelectorOptions
    )
    dbg_config: DeBruijnGraphOptions = dataclasses.field(
        default_factory=DeBruijnGraphOptions
    )
    aln_config: AlignerOptions = dataclasses.field(
        default_factory=AlignerOptions
    )
    split_skip_reads: bool = False
    normalize_reads: bool = False

"""Stage 3: CVOs -> finished VCF / gVCF.

The port's copy of `deepvariant_tpu.postprocess.pipeline`, on the host in
Python as there: the same sort, grouping, merge, genotype and phase-set
stitching, and the same gVCF merge of variants with reference blocks, so
the same VCF and gVCF bytes from the same CVOs and blocks.

Mirrors the reference's postprocess_variants.py main flow
(:1741-2230): sort + group CVOs by locus, merge multiallelics, resolve
genotypes, resolve conflicting overlapping variants, then either write
the VCF directly or merge with gVCF ref blocks
(nucleus merge_variants.cc:159-232 semantics re-implemented here).

Partition-parallelism uses multiprocessing like the reference
(`_process_partitions_in_parallel`, :1887): this stage is host-bound
string and file work, none of it on the card.
"""

from __future__ import annotations

import itertools
import os
from typing import (
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.core.types import (
    CallVariantsOutput,
    ContigInfo,
    Range,
    Variant,
)
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.io.vcf import (
    GERMLINE_FILTER,
    PASS_FILTER,
    PON_FILTER,
    VcfWriter,
    deepvariant_header,
)
from deepvariant_tpu_torch.postprocess import genotype as gt
from deepvariant_tpu_torch.postprocess import haplotypes
from deepvariant_tpu_torch.postprocess.merge import merge_predictions

GVCF_ALT_ALLELE = "<*>"
_GVCF_ALT_ALLELE_GL = -99  # merge_variants.cc:48


def read_cvos_sorted(
    paths: Sequence[str], contigs: Sequence[ContigInfo]
) -> List[CallVariantsOutput]:
    """Load all CVO shards, sorted by (contig order, start, end)."""
    contig_index = {c.name: i for i, c in enumerate(contigs)}
    cvos = []
    for path in paths:
        with TFRecordReader(path) as reader:
            for buf in reader:
                cvos.append(CallVariantsOutput.decode(buf))
    cvos.sort(
        key=lambda c: (
            contig_index.get(c.variant.reference_name, 1 << 30),
            c.variant.start,
            c.variant.end,
        )
    )
    return cvos


def group_cvos(
    cvos: Iterable[CallVariantsOutput], group_variants: bool = True
) -> Iterator[List[CallVariantsOutput]]:
    """Group CVOs sharing a variant range (postprocess_variants.py:1467)."""
    if not group_variants:
        for cvo in cvos:
            yield [cvo]
        return
    keyfn = lambda c: (
        c.variant.reference_name, c.variant.start, c.variant.end
    )
    for _, group in itertools.groupby(cvos, keyfn):
        yield list(group)


def _sort_group(group: List[CallVariantsOutput]) -> List[CallVariantsOutput]:
    return sorted(group, key=lambda x: sorted(x.alt_allele_indices))


# -- cross-region phase-set stitching ---------------------------------------
# (postprocess_variants.{h,cc}: PhaseSetStitchingStatus, StitchPhaseSets,
# MaybeSwapPhase, GetVariantPhaseInformation.)

PS_STITCH_MATCH = 0
PS_STITCH_SWITCH = 1
PS_STITCH_NOT_ENOUGH_OVERLAP = 2
_FIRST_VARIANT_IN_BLOCK = "FIRST_VARIANT_IN_BLOCK"


class _PhaseInfo:
    """VariantPhaseInformation (postprocess_variants.h:60-72)."""

    __slots__ = ("shard", "region", "status", "is_first",
                 "first_start", "was_phased")

    def __init__(self, shard="-1", region="-1",
                 status=PS_STITCH_MATCH, is_first=False,
                 first_start=-1, was_phased=False):
        self.shard = shard
        self.region = region
        self.status = status
        self.is_first = is_first
        self.first_start = first_start
        self.was_phased = was_phased

    def is_null(self) -> bool:
        return self.shard == "-1" and self.region == "-1"


def load_phase_switches(path: str) -> Dict[Tuple[str, str], int]:
    """Parse the merge_phased_reads switches TSV: shard<TAB>region<TAB>
    status (postprocess_variants.cc LoadPhasingInfo)."""
    out: Dict[Tuple[str, str], int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) != 3:
                raise ValueError(
                    f"Invalid line in switches file: {line!r}"
                )
            out[(parts[0], parts[1])] = int(parts[2])
    return out


def _variant_phase_info(
    variant: Variant,
    switches: Dict[Tuple[str, str], int],
    prev: _PhaseInfo,
) -> _PhaseInfo:
    """GetVariantPhaseInformation (postprocess_variants.cc:88-141)."""
    ps_contig = variant.info.get(gt.VARIANT_PHASE_SET)
    if not ps_contig:
        return prev
    shard, sep, region = str(ps_contig[0]).partition("-")
    if not sep:
        raise ValueError(f"Invalid PS_CONTIG: {ps_contig[0]!r}")
    status = switches.get((shard, region), PS_STITCH_MATCH)
    if prev.is_null():
        return _PhaseInfo(shard, region, status, True, variant.start)
    if shard == prev.shard and region == prev.region:
        new = _PhaseInfo(prev.shard, prev.region, prev.status,
                         prev.is_first, prev.first_start,
                         prev.was_phased)
        if prev.was_phased:
            new.is_first = False
        return new
    # Region boundary: start a new phase set when the variant begins a
    # fresh phasing block or the regions had too little read overlap
    # to orient each other; otherwise stitch onto the previous set.
    first = variant.info.get(_FIRST_VARIANT_IN_BLOCK)
    is_first = bool(first and first[0])
    if is_first or status == PS_STITCH_NOT_ENOUGH_OVERLAP:
        return _PhaseInfo(shard, region, status, True, variant.start)
    return _PhaseInfo(prev.shard, prev.region, status, False,
                      prev.first_start)


def _maybe_swap_phase(variant: Variant, info: _PhaseInfo) -> None:
    """MaybeSwapPhase (postprocess_variants.cc:144-170): on a SWITCH
    region, reverse the phased het genotype order; set FORMAT/PS to
    the 1-based start of the block's first variant."""
    if not variant.calls:
        return
    call = variant.calls[0]
    if not (variant.info.get(gt.VARIANT_PHASE_SET)
            and variant.info.get(gt.PHASED_GENOTYPE)) \
            or not call.is_phased:
        return
    if info.status == PS_STITCH_SWITCH and \
            call.genotype[0] != call.genotype[1]:
        call.genotype = [call.genotype[1], call.genotype[0]]
    call.is_phased = True
    call.info["PS"] = [info.first_start + 1]


def cvos_to_variants(
    cvos: Iterable[CallVariantsOutput],
    sample_name: str,
    qual_filter: float = 1.0,
    multi_allelic_qual_filter: float = 1.0,
    cnn_homref_call_min_gq: float = gt.CNN_HOMREF_CALL_MIN_GQ,
    multiallelic_mode: str = "product",
    haploid_contigs: Optional[Set[str]] = None,
    par_regions=None,
    group_variants: bool = True,
    phase_switches: Optional[Dict[Tuple[str, str], int]] = None,
    multiallelic_model=None,
    debug_output_all_candidates: Optional[str] = None,
) -> Iterator[Variant]:
    """CVO stream (sorted) -> resolved Variant stream.

    multiallelic_mode default is 'product' (reference flag default,
    postprocess_variants.py:206-210).

    phase_switches: optional {(shard, region): status} map from a
    merge_phased_reads switches TSV; drives cross-region phase-set
    stitching (StitchPhaseSets semantics). Without it every region
    stitches as MATCH."""
    phase_switches = phase_switches or {}
    phase_info = _PhaseInfo()
    for group in group_cvos(cvos, group_variants):
        outputs = _sort_group(group)
        canonical_variant, predictions = merge_predictions(
            outputs,
            multi_allelic_qual_filter,
            multiallelic_mode=multiallelic_mode,
            haploid_contigs=haploid_contigs,
            par_regions=par_regions,
            multiallelic_model=multiallelic_model,
            debug_output_all_candidates=debug_output_all_candidates,
        )
        variant = gt.add_call_to_variant(
            canonical_variant,
            predictions,
            qual_filter=qual_filter,
            sample_name=sample_name,
            cnn_homref_call_min_gq=cnn_homref_call_min_gq,
        )
        phase_info = _variant_phase_info(
            variant, phase_switches, phase_info
        )
        _maybe_swap_phase(variant, phase_info)
        if variant.calls and variant.calls[0].is_phased:
            phase_info.was_phased = True
        # Internal phasing info fields stay out of the VCF INFO column.
        variant.info.pop(gt.PHASED_GENOTYPE, None)
        variant.info.pop(gt.VARIANT_PHASE_SET, None)
        variant.info.pop(_FIRST_VARIANT_IN_BLOCK, None)
        yield variant


def transform_to_gvcf(variant: Variant) -> Variant:
    """Add the <*> alt allele + GLs/AD/VAF (merge_variants.cc:70-93)."""
    if GVCF_ALT_ALLELE in variant.alternate_bases:
        return variant
    variant.alternate_bases.append(GVCF_ALT_ALLELE)
    if variant.calls:
        call = variant.calls[0]
        for _ in range(len(variant.alternate_bases) + 1):
            call.genotype_likelihood.append(_GVCF_ALT_ALLELE_GL)
        if "AD" in call.info:
            call.info["AD"] = list(call.info["AD"]) + [0]
        if "VAF" in call.info:
            call.info["VAF"] = list(call.info["VAF"]) + [0.0]
    return variant


def zero_scale_gl(variant: Variant) -> Variant:
    """Shift GLs so max is 0 (merge_variants.cc:96-104)."""
    if variant.calls and variant.calls[0].genotype_likelihood:
        call = variant.calls[0]
        m = max(call.genotype_likelihood)
        call.genotype_likelihood = [g - m for g in call.genotype_likelihood]
    return variant


def _record_from_template(
    template: Variant, start: int, end: int, ref_lookup
) -> Variant:
    import copy

    v = copy.deepcopy(template)
    v.start = start
    v.end = end
    if "END" in v.info:
        v.info["END"] = [end]
    if start != template.start and ref_lookup is not None:
        v.reference_bases = ref_lookup(v.reference_name, start)
    return v


def fasta_ref_lookup(reader):
    """`fn(contig, pos) -> base` over a `FastaReader`: the one reference
    base at `pos`, which a reference block that a variant truncates takes
    as its first base in `merge_variants_and_nonvariants`."""
    def lookup(contig: str, pos: int) -> str:
        return reader.query(Range(contig, pos, pos + 1))

    return lookup


def merge_variants_and_nonvariants(
    variants: Iterable[Variant],
    nonvariants: Iterable[Variant],
    contigs: Sequence[ContigInfo],
    ref_lookup=None,
    only_keep_pass: bool = False,
) -> Iterator[Tuple[str, Variant]]:
    """Interleave variant + ref-block streams (merge_variants.cc:159-232).

    Yields ('vcf', v) and ('gvcf', v) events in order. Both streams are
    sorted in the order of `contigs`, which decides which record goes
    first where the streams stand on different contigs. `ref_lookup` is
    `fn(contig, pos) -> base` (`fasta_ref_lookup`) used when truncated
    ref blocks need a new leading reference base.
    """
    order = {c.name: i for i, c in enumerate(contigs)}
    var_iter = iter(variants)
    nonvar_iter = iter(nonvariants)
    variant = next(var_iter, None)
    nonvariant = next(nonvar_iter, None)
    while variant is not None or nonvariant is not None:
        if nonvariant is None or (
            variant is not None
            and (variant.reference_name != nonvariant.reference_name
                 or variant.end <= nonvariant.start)
            and not _contig_after(variant, nonvariant, order)
        ):
            if not only_keep_pass or variant.filter == [PASS_FILTER]:
                yield "vcf", variant
            gv = zero_scale_gl(variant)
            yield "gvcf", transform_to_gvcf(gv)
            variant = next(var_iter, None)
        elif variant is None or (
            (nonvariant.reference_name != variant.reference_name
             or nonvariant.end <= variant.start)
            and not _contig_after(nonvariant, variant, order)
        ):
            yield "gvcf", nonvariant
            nonvariant = next(nonvar_iter, None)
        else:
            # Overlap: split the ref block around the variant.
            if nonvariant.start < variant.start:
                yield "gvcf", _record_from_template(
                    nonvariant, nonvariant.start, variant.start, ref_lookup
                )
            if nonvariant.end > variant.end:
                nonvariant = _record_from_template(
                    nonvariant, variant.end, nonvariant.end, ref_lookup
                )
            else:
                nonvariant = next(nonvar_iter, None)


def _contig_after(a: Variant, b: Variant, order: Dict[str, int]) -> bool:
    """Whether `a` lies on a contig after `b`'s in `order`. Contigs
    outside the order sort last, as in `_read_nonvariants`."""
    return order.get(a.reference_name, 1 << 30) > \
        order.get(b.reference_name, 1 << 30)


def postprocess_variants(
    cvo_path: str,
    output_vcf: str,
    contigs: Sequence[ContigInfo],
    sample_name: str = "default",
    qual_filter: float = 1.0,
    multi_allelic_qual_filter: float = 1.0,
    cnn_homref_call_min_gq: float = gt.CNN_HOMREF_CALL_MIN_GQ,
    multiallelic_mode: str = "product",
    haploid_contigs: Optional[Set[str]] = None,
    par_regions=None,
    nonvariant_site_path: Optional[str] = None,
    output_gvcf: Optional[str] = None,
    ref_lookup=None,
    only_keep_pass: bool = False,
    group_variants: bool = True,
    phased_reads_switches_path: Optional[str] = None,
    use_multiallelic_model: bool = False,
    process_somatic: bool = False,
    pon_vcf_path: Optional[str] = None,
    regions=None,
    debug_output_all_candidates: Optional[str] = None,
) -> dict:
    """Full stage-3 run. Returns summary stats.

    `cvo_path` may be a single sharded spec or a list of specs (e.g.
    CNN CVOs + small-model CVOs, joined before grouping like the
    reference's --small_model_cvo_records input).

    `process_somatic` (DeepSomatic, --process_somatic): heterozygous
    calls are germline — their GT becomes 0/0 and a non-empty filter
    is replaced with GERMLINE (vcf_writer.cc WriteSomatic:163-177).
    `pon_vcf_path` marks PASS variants found in the Panel of Normals
    VCF with the PON filter (postprocess_variants.py:1315-1346)."""
    specs = [cvo_path] if isinstance(cvo_path, str) else list(cvo_path)
    if specs and not isinstance(specs[0], str):
        # In-memory CVOs from the fused streaming pipeline
        # (parallel/stream_pipeline.py): same sort-by-locus contract
        # as read_cvos_sorted, no intermediate file.
        order = {c.name: i for i, c in enumerate(contigs)}
        cvos = sorted(
            specs,
            key=lambda c: (order.get(c.variant.reference_name, 1 << 30),
                           c.variant.start, c.variant.end),
        )
    else:
        paths: List[str] = []
        for spec in specs:
            if spec:
                paths.extend(glob_sharded_inputs(spec))
        cvos = read_cvos_sorted(paths, contigs)
    if regions is not None:
        # --regions (postprocess_variants.py:262): only candidates
        # starting inside the requested ranges are emitted.
        cvos = [
            c for c in cvos
            if regions.overlaps(c.variant.reference_name,
                                c.variant.start)
        ]
    phase_switches = None
    if phased_reads_switches_path:
        phase_switches = load_phase_switches(phased_reads_switches_path)
    multiallelic_model = None
    if use_multiallelic_model:
        from deepvariant_tpu_torch.postprocess.multiallelic_model import (
            load_multiallelic_model,
        )

        multiallelic_model = load_multiallelic_model()
    if use_multiallelic_model and debug_output_all_candidates == "ALT":
        raise ValueError(
            "debug_output_all_candidates=ALT is incompatible with the "
            "multiallelic model. Use INFO instead."
        )
    variants = cvos_to_variants(
        cvos,
        sample_name,
        qual_filter=qual_filter,
        multi_allelic_qual_filter=multi_allelic_qual_filter,
        cnn_homref_call_min_gq=cnn_homref_call_min_gq,
        multiallelic_mode=multiallelic_mode,
        haploid_contigs=haploid_contigs,
        par_regions=par_regions,
        group_variants=group_variants,
        phase_switches=phase_switches,
        multiallelic_model=multiallelic_model,
        debug_output_all_candidates=debug_output_all_candidates,
    )
    variants = haplotypes.maybe_resolve_conflicting_variants(
        variants, qual_filter=qual_filter
    )
    extra_filters = []
    if process_somatic:
        extra_filters.append(("GERMLINE", "Non somatic variants"))
        if pon_vcf_path:
            extra_filters.append(
                ("PON", "Filtered by Panel of Normals (PON)")
            )
        variants = _apply_somatic_filters(variants, pon_vcf_path)
    elif pon_vcf_path:
        raise ValueError(
            "PON filtering is only supported for somatic variant calling."
        )
    header = deepvariant_header(
        contigs, [sample_name], extra_filter_lines=extra_filters or None,
        include_somatic_fields=process_somatic,
    )
    n_vcf = n_gvcf = 0
    if nonvariant_site_path and output_gvcf:
        nonvariants = _read_nonvariants(nonvariant_site_path, contigs)
        with VcfWriter(output_vcf, header) as vcf_w, \
                VcfWriter(output_gvcf, header) as gvcf_w:
            for kind, v in merge_variants_and_nonvariants(
                variants, nonvariants, contigs, ref_lookup=ref_lookup,
                only_keep_pass=only_keep_pass,
            ):
                if kind == "vcf":
                    vcf_w.write(v)
                    n_vcf += 1
                else:
                    gvcf_w.write(v)
                    n_gvcf += 1
    else:
        with VcfWriter(output_vcf, header) as vcf_w:
            for v in variants:
                if not only_keep_pass or v.filter == [PASS_FILTER]:
                    vcf_w.write(v)
                    n_vcf += 1
    return {"vcf_records": n_vcf, "gvcf_records": n_gvcf}


def _apply_somatic_filters(
    variants: Iterable[Variant], pon_vcf_path: Optional[str]
) -> Iterator[Variant]:
    """DeepSomatic output semantics: het calls become germline
    (GT 0/0, GERMLINE filter; vcf_writer.cc WriteSomatic), then PASS
    variants matching a Panel-of-Normals record get the PON filter
    (postprocess_variants.py add_pon_filter:1335-1346)."""
    pon_keys = None
    if pon_vcf_path:
        from deepvariant_tpu_torch.io.vcf import VcfReader

        pon_keys = set()
        for rec in VcfReader(pon_vcf_path):
            pon_keys.add((
                rec.reference_name, rec.start, rec.reference_bases,
                tuple(sorted(rec.alternate_bases)),
            ))
    for v in variants:
        gt = v.calls[0].genotype if v.calls else []
        if gt not in ([0, 0], [-1, -1], [1, 1]):
            v.calls[0].genotype = [0, 0]
            if v.filter:
                v.filter = [GERMLINE_FILTER]
        if (pon_keys is not None and PASS_FILTER in v.filter):
            key = (v.reference_name, v.start, v.reference_bases,
                   tuple(sorted(v.alternate_bases)))
            if key in pon_keys:
                v.filter = [
                    f for f in v.filter if f != PASS_FILTER
                ] + [PON_FILTER]
        yield v


def _read_nonvariants(
    path, contigs: Sequence[ContigInfo]
) -> Iterator[Variant]:
    """`path` is a sharded TFRecord spec, or a list of in-memory
    Variant records from the fused streaming pipeline — both get the
    same (contig, start, end) sort, so stream and staged gVCF merges
    see identical record order."""
    contig_index = {c.name: i for i, c in enumerate(contigs)}
    if isinstance(path, str):
        records = []
        for p in glob_sharded_inputs(path):
            with TFRecordReader(p) as reader:
                for buf in reader:
                    records.append(Variant.decode(buf))
    else:
        records = list(path)
    records.sort(
        key=lambda v: (
            contig_index.get(v.reference_name, 1 << 30), v.start, v.end
        )
    )
    return iter(records)


# ---------------------------------------------------------------------------
# Partition-parallel stage 3 (postprocess_variants.py:1887
# _process_partitions_in_parallel)
# ---------------------------------------------------------------------------

def _partition_worker(args):
    """Process one partition group (a list of contig ranges,
    calling_regions_utils.py partition_calling_regions) into a temp
    body-only VCF."""
    (cvo_path, contigs, group, sample_name, kwargs, tmp_path) = args

    def in_group(v):
        return any(
            v.reference_name == p.reference_name
            and p.start <= v.start < p.end
            for p in group
        )

    cvos = [
        c for c in read_cvos_sorted(
            [p for spec in (
                [cvo_path] if isinstance(cvo_path, str) else cvo_path
            ) for p in glob_sharded_inputs(spec)],
            contigs,
        )
        if in_group(c.variant)
    ]
    variants = haplotypes.maybe_resolve_conflicting_variants(
        cvos_to_variants(cvos, sample_name, **kwargs),
        qual_filter=kwargs.get("qual_filter", 1.0),
    )
    from deepvariant_tpu_torch.io.vcf import format_variant_line

    with open(tmp_path, "w") as f:
        n = 0
        for v in variants:
            f.write(format_variant_line(v) + "\n")
            n += 1
    return n


def postprocess_variants_parallel(
    cvo_path,
    output_vcf: str,
    contigs: Sequence[ContigInfo],
    sample_name: str = "default",
    num_partitions: int = 4,
    processes: Optional[int] = None,
    **kwargs,
) -> dict:
    """Multiprocess partitioned stage-3 (plain-text VCF output).

    Contig space splits into `num_partitions` ranges processed by a
    process pool; per-partition temp VCF bodies are concatenated in
    genomic order (the reference's temp-file concat flow). The pool's
    processes are spawned, as the stream's workers are, so that a caller
    holding a CUDA context is never forked; the temp bodies live in a
    directory beside `output_vcf` that is removed afterwards.
    """
    import multiprocessing
    import tempfile

    from deepvariant_tpu_torch.core.ranges import (
        RangeSet,
        partition_calling_regions,
    )
    from deepvariant_tpu_torch.io.vcf import deepvariant_header

    groups = partition_calling_regions(
        RangeSet.from_contigs(list(contigs)), num_partitions
    )
    tmpdir = tempfile.TemporaryDirectory(
        prefix="dv_postprocess_",
        dir=os.path.dirname(os.path.abspath(output_vcf)))
    jobs = []
    for i, group in enumerate(groups):
        jobs.append((
            cvo_path, list(contigs), group, sample_name, kwargs,
            os.path.join(tmpdir.name, f"part-{i:05d}.vcf_body"),
        ))
    processes = processes or min(len(jobs), os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(processes) as pool:
        counts = pool.map(_partition_worker, jobs)
    extra_filters = []
    if kwargs.get("process_somatic"):
        extra_filters.append(("GERMLINE", "Non somatic variants"))
        if kwargs.get("pon_vcf_path"):
            extra_filters.append(
                ("PON", "Filtered by Panel of Normals (PON)")
            )
    header = deepvariant_header(
        contigs, [sample_name],
        extra_filter_lines=extra_filters or None,
        include_somatic_fields=bool(kwargs.get("process_somatic")),
    )
    with open(output_vcf, "w") as out:
        for line in header.lines():
            out.write(line + "\n")
        for i in range(len(jobs)):
            with open(jobs[i][-1]) as f:
                out.write(f.read())
    tmpdir.cleanup()
    return {"vcf_records": sum(counts), "partitions": len(jobs)}


"""Candidates to tf.Examples and device-encode plans (ExamplesGenerator
parity).

The port's copy of `deepvariant_tpu.make_examples.examples_builder`,
which mirrors make_examples_native.cc: AltAlleleCombinations (:191-268),
GetReferenceBasesForPileup (:516-540, N-padding at contig edges),
CreateAndWriteExamplesForCandidate (:632-720, read-overlap window
selection) and EncodeExample's feature schema (:388-470). Two outputs
per (candidate, alt combination): a host-painted tf.Example
(`build_examples_for_candidate`, through `PileupEncoder.build_pileup`,
with the alt-aligned images that `alt_aligned.compose_alt_aligned` joins
in every mode), or a plan whose painting runs on the card
(`build_plans_for_candidate`). Both take the same trimmed reads
(`prepare_candidate_batch`) and reads realigned to each alt haplotype
(`iter_alt_batches`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io.bam import ReadBatch
from deepvariant_tpu_torch.make_examples.pileup import (
    PileupEncoder,
    PileupOptions,
    reads_overlapping_variant,
)
from deepvariant_tpu_torch.make_examples.variant_caller import DeepVariantCall

# EncodedVariantType (make_examples_native.cc:301-320).
VARIANT_TYPE_UNKNOWN = 0
VARIANT_TYPE_SNP = 1
VARIANT_TYPE_INDEL = 2


def encoded_variant_type(variant: Variant) -> int:
    if len(variant.reference_bases) == 1 and variant.alternate_bases:
        if all(len(a) == 1 for a in variant.alternate_bases):
            return VARIANT_TYPE_SNP
    if len(variant.reference_bases) > 1:
        return VARIANT_TYPE_INDEL
    if any(len(a) > 1 for a in variant.alternate_bases):
        return VARIANT_TYPE_INDEL
    return VARIANT_TYPE_UNKNOWN


def alt_allele_combinations(
    variant: Variant, multi_allelic_mode: str = "add_het_alt",
    allowed_alt_index_sets: Optional[Sequence[Tuple[int, ...]]] = None,
) -> List[List[str]]:
    """ADD_HET_ALT_IMAGES: every 1- and 2-subset of alts
    (make_examples_native.cc:207-227).

    `allowed_alt_index_sets` restricts the enumeration to the given
    alt-index tuples (AltAlleleCombinationsFromIndices,
    make_examples_native.cc:234-268) — the small-model gate removes
    the sets it already called from the CNN's workload."""
    alts = list(variant.alternate_bases)
    if allowed_alt_index_sets is not None:
        if multi_allelic_mode == "no_het_alt":
            return [[alts[s[0]]] for s in allowed_alt_index_sets
                    if len(s) == 1]
        return [[alts[i] for i in s] for s in allowed_alt_index_sets]
    if multi_allelic_mode == "no_het_alt":
        return [[a] for a in alts]
    with_ref = [variant.reference_bases] + alts
    out = []
    for i in range(len(with_ref)):
        for j in range(i + 1, len(with_ref)):
            combo = []
            if i > 0:
                combo.append(with_ref[i])
            combo.append(with_ref[j])
            out.append(combo)
    return out


@dataclasses.dataclass
class BuiltExample:
    encoded: bytes
    variant: Variant
    alt_indices: List[int]
    image: np.ndarray
    label: Optional[int] = None


@dataclasses.dataclass
class PlannedExample:
    """Device-encode payload for one (candidate, alt-combo) example.

    `plan` holds the pileup_device row tensors (host-side planning done,
    painting deferred to the device); crosses the stream-pipeline
    worker queue instead of a host-painted image
    (reference fast_pipeline shm analog, stream_examples_kernel.cc)."""

    plan: dict
    variant: Variant
    alt_indices: List[int]
    variant_type: int
    label: Optional[int] = None


class ExamplesBuilder:
    """Builds tf.Examples for the candidates of one region."""

    def __init__(
        self,
        ref_reader,
        pileup_options: Optional[PileupOptions] = None,
        sequencing_type: int = 0,
        trim_reads_for_pileup: bool = False,
    ):
        self.ref = ref_reader
        self.pileup_options = pileup_options or PileupOptions()
        self.encoder = PileupEncoder(self.pileup_options)
        self.sequencing_type = sequencing_type
        self.trim_reads_for_pileup = trim_reads_for_pileup

    def reference_window(self, variant: Variant) -> Optional[np.ndarray]:
        """Pileup-width ref bases centered at variant.start, N-padded at
        contig edges (GetReferenceBasesForPileup)."""
        o = self.pileup_options
        start = variant.start - o.half_width
        end = start + o.width
        n_bases = self.ref.contig_length(variant.reference_name)
        lo = max(0, start)
        hi = min(n_bases, end)
        if lo >= hi:
            return None
        bases = self.ref.bases(Range(variant.reference_name, lo, hi))
        if start < 0 or end > n_bases:
            out = np.full(o.width, ord("N"), np.uint8)
            out[lo - start : lo - start + len(bases)] = bases
            return out
        return bases

    def need_alt_alignment(self, variant: Variant) -> bool:
        """NeedAltAlignment (make_examples_native.cc:500-512)."""
        o = self.pileup_options
        if o.alt_aligned_pileup == "none" or not o.alt_aligned_pileup:
            return False
        if o.types_to_alt_align == "all":
            return True
        if o.types_to_alt_align == "indels":
            return len(variant.reference_bases) > 1 or any(
                len(a) > 1 for a in variant.alternate_bases
            )
        return False

    def iter_alt_batches(
        self,
        dv_call: DeepVariantCall,
        batch: ReadBatch,
        combo: Sequence[str],
        sort_positions=None,
    ):
        """Per-alt realigned inputs for alt-aligned pileups.

        Yields (remapped_call, alt_batch, alt_sort_positions,
        hap_window) per alt in combo, or None when the haplotype is too
        short. Shared by the host painter (_build_alt_images) and the
        planner (pileup_device.plan_longread_example), so both see
        identical realigned read sets."""
        from deepvariant_tpu_torch.io.bam import ReadBatch as _RB
        from deepvariant_tpu_torch.make_examples import alt_aligned as aa

        o = self.pileup_options
        variant = dv_call.variant
        contig = variant.reference_name
        contig_n_bases = self.ref.contig_length(contig)
        trimmed = batch.to_reads()
        for alt in combo:
            haplotype, ref_start, ref_end = aa.create_haplotype(
                variant, alt, o.half_width, self.ref.query, contig_n_bases
            )
            if len(haplotype) < o.width:
                yield None
                continue
            realigned = aa.realign_reads_to_haplotype(
                haplotype, trimmed, contig, ref_start, ref_end,
                self.ref.query, contig_n_bases,
            )
            kept = [(r, orig) for orig, r in enumerate(realigned)
                    if r.aligned_sequence]
            alt_batch = _RB.from_reads([r for r, _ in kept], [contig])
            # Remap allele support into the alt batch's index space.
            new_index = {orig: i for i, (_, orig) in enumerate(kept)}
            remapped = DeepVariantCall(
                variant=variant,
                allele_support={
                    a: [new_index[r] for r in ids if r in new_index]
                    for a, ids in dv_call.allele_support.items()
                },
                ref_support=[
                    new_index[r] for r in dv_call.ref_support
                    if r in new_index
                ],
            )
            alt_sort_pos = None
            if sort_positions is not None:
                alt_sort_pos = np.array(
                    [sort_positions[orig] for _, orig in kept], np.int64
                )
            hap_window = np.frombuffer(
                haplotype[: o.width].encode(), np.uint8
            )
            yield (remapped, alt_batch, alt_sort_pos, hap_window)

    def _build_alt_images(
        self,
        dv_call: DeepVariantCall,
        batch: ReadBatch,
        combo: Sequence[str],
        sort_positions=None,
    ) -> List[Optional[np.ndarray]]:
        """One pileup per alt in combo, reads realigned to the alt
        haplotype (CreateAltAlignedImages, make_examples_native.cc:553).

        `batch` is the already-trimmed pileup batch (the caller trims
        whenever alt alignment is needed); `sort_positions` carries the
        reads' original alignment positions so alt rows sort exactly
        like the reference's (alignment_positions,
        pileup_image_native.cc:397-401)."""
        alt_images: List[Optional[np.ndarray]] = []
        for item in self.iter_alt_batches(
            dv_call, batch, combo, sort_positions=sort_positions
        ):
            if item is None:
                alt_images.append(None)
                continue
            remapped, alt_batch, alt_sort_pos, hap_window = item
            alt_images.append(self.encoder.build_pileup(
                remapped, hap_window, alt_batch,
                np.arange(len(alt_batch)), combo,
                sort_positions=alt_sort_pos,
            ))
        return alt_images

    def prepare_candidate_batch(
        self,
        dv_call: DeepVariantCall,
        batch: ReadBatch,
    ):
        """Candidate-local read set: trimming + support remapping.

        Trimmed-read pileup is engaged by --trim_reads_for_pileup OR
        whenever the variant needs alt alignment (use_trimmed_reads,
        make_examples_native.cc:655-658). Reads are trimmed to the
        alignment region (TrimReads, alt_aligned_pileup_lib.cc:250-268;
        min_overlap 15), support indices are remapped, and rows keep
        sorting by the reads' ORIGINAL alignment positions. The
        reference builds the trimmed read set from a query of variant
        +/- read_overlap_buffer_bp (make_examples_native.cc:644-648),
        so window reads that don't overlap the variant never reach the
        trimmed/alt-aligned pileups.

        Returns (dv_call, batch, read_indices, sort_positions); shared
        by the host painter and the device long-read encoder
        (pileup_device.encode_longread_examples).
        """
        variant = dv_call.variant
        read_indices = reads_overlapping_variant(
            batch, variant, self.pileup_options.read_overlap_buffer_bp
        )
        needs_alt = self.need_alt_alignment(variant)
        sort_positions = None
        if (self.trim_reads_for_pileup or needs_alt) and len(batch):
            from deepvariant_tpu_torch.io.bam import ReadBatch
            from deepvariant_tpu_torch.make_examples import alt_aligned as aa

            region = aa.calculate_alignment_region(
                variant, self.pileup_options.half_width,
                self.ref.contig_length(variant.reference_name),
            )
            reads = batch.to_reads()
            buf = self.pileup_options.read_overlap_buffer_bp
            q_start = variant.start - buf
            q_end = variant.start + len(variant.reference_bases) + buf
            keep = [i for i, r in enumerate(reads)
                    if r.position < q_end and r.end() > q_start]
            reads = [reads[i] for i in keep]
            remap_support = {orig: i for i, orig in enumerate(keep)}
            dv_call = dataclasses.replace(
                dv_call,
                allele_support={
                    a: [remap_support[r] for r in ids
                        if r in remap_support]
                    for a, ids in dv_call.allele_support.items()
                },
                ref_support=[
                    remap_support[r] for r in dv_call.ref_support
                    if r in remap_support
                ],
            )
            trimmed, original_indices = aa.trim_reads(reads, region)
            sort_positions = np.array(
                [reads[i].position for i in original_indices], np.int64
            )
            batch = ReadBatch.from_reads(
                trimmed, [variant.reference_name]
            )
            new_index = {o: i for i, o in enumerate(original_indices)}
            dv_call = dataclasses.replace(
                dv_call,
                allele_support={
                    a: [new_index[r] for r in ids if r in new_index]
                    for a, ids in dv_call.allele_support.items()
                },
                ref_support=[
                    new_index[r] for r in dv_call.ref_support
                    if r in new_index
                ],
            )
            read_indices = reads_overlapping_variant(
                batch, variant,
                self.pileup_options.read_overlap_buffer_bp,
            )
        return dv_call, batch, read_indices, sort_positions

    def build_examples_for_candidate(
        self,
        dv_call: DeepVariantCall,
        batch: ReadBatch,
        label_fn=None,
        allowed_alt_index_sets=None,
    ) -> Iterator[BuiltExample]:
        from deepvariant_tpu_torch.make_examples import alt_aligned as aa

        variant = dv_call.variant
        ref_window = self.reference_window(variant)
        if ref_window is None or len(ref_window) != self.pileup_options.width:
            return
        alt_index = {a: i for i, a in enumerate(variant.alternate_bases)}
        locus = f"{variant.reference_name}:{variant.start + 1}-{variant.end}"
        needs_alt = self.need_alt_alignment(variant)
        mode = self.pileup_options.alt_aligned_pileup
        dv_call, batch, read_indices, sort_positions = \
            self.prepare_candidate_batch(dv_call, batch)
        for combo in alt_allele_combinations(
            variant, self.pileup_options.multi_allelic_mode,
            allowed_alt_index_sets=allowed_alt_index_sets,
        ):
            image = self.encoder.build_pileup(
                dv_call, ref_window, batch, read_indices, combo,
                sort_positions=sort_positions,
            )
            if mode and mode != "none":
                # The composed shape is constant for all examples; when
                # this variant needs no alt alignment (e.g. SNPs with
                # types_to_alt_align=indels) the alt planes are zeros
                # (FillPileupArray's empty-alt handling).
                alt_images = self._build_alt_images(
                    dv_call, batch, combo,
                    sort_positions=sort_positions,
                ) if needs_alt else [None, None]
                image = aa.compose_alt_aligned(image, alt_images, mode,
                                               combo)
            indices = sorted(alt_index[a] for a in combo if a in alt_index)
            label = None
            if label_fn is not None:
                label = label_fn(variant, indices)
            encoded = example_codec.make_example(
                variant,
                image,
                indices,
                locus,
                sequencing_type=self.sequencing_type,
                label=label,
            )
            yield BuiltExample(encoded, variant, indices, image, label)

    def supports_device_encode(self) -> bool:
        """True when this channel/alt-mode config can be painted by the
        device encoder (pileup_device.make_longread_encode_fn)."""
        from deepvariant_tpu_torch.make_examples.pileup_device import (
            DEVICE_CHANNELS,
        )

        o = self.pileup_options
        return (
            all(ch in DEVICE_CHANNELS for ch in o.channels)
            and o.alt_aligned_pileup in ("", "none", "diff_channels")
        )

    def build_plans_for_candidate(
        self,
        dv_call: DeepVariantCall,
        batch: ReadBatch,
        label_fn=None,
        allowed_alt_index_sets=None,
    ) -> Iterator[PlannedExample]:
        """Device-encode twin of build_examples_for_candidate: the same
        candidate/combo loop, but each example's host work stops after
        row planning (pileup_device.plan_longread_example); the channel
        painting runs later on the card, one launch of the paint kernel
        per batch, before the CNN forward."""
        from deepvariant_tpu_torch.make_examples import pileup_device

        variant = dv_call.variant
        alt_index = {a: i for i, a in enumerate(variant.alternate_bases)}
        for combo in alt_allele_combinations(
            variant, self.pileup_options.multi_allelic_mode,
            allowed_alt_index_sets=allowed_alt_index_sets,
        ):
            plan = pileup_device.plan_longread_example(
                self, dv_call, batch, combo
            )
            if plan is None:
                # Reference window unavailable (contig edge):
                # build_examples_for_candidate emits nothing either.
                return
            indices = sorted(
                alt_index[a] for a in combo if a in alt_index
            )
            label = None
            if label_fn is not None:
                label = label_fn(variant, indices)
            yield PlannedExample(
                plan=plan,
                variant=variant,
                alt_indices=indices,
                variant_type=encoded_variant_type(variant),
                label=label,
            )

    def example_shape(self) -> Tuple[int, int, int]:
        """Final tensor shape incl. alt-aligned composition
        (CalculatePileupImageHeight, pileup_image_native.cc:220-240)."""
        o = self.pileup_options
        h, w, c = o.height, o.width, len(o.channels)
        mode = o.alt_aligned_pileup
        if mode in ("diff_channels", "base_channels"):
            c += 2
        elif mode == "rows":
            h *= 3
        elif mode == "single_row":
            h *= 2
        return (h, w, c)

    # DeepVariantChannelEnum values for the alt-aligned planes
    # (deepvariant.proto:1308-1313).
    _ALT_CHANNEL_ENUMS = {
        "diff_channels": [9, 10],
        "base_channels": [20, 21],
    }

    def channel_enums(self) -> List[int]:
        enums = list(self.pileup_options.channels)
        enums += self._ALT_CHANNEL_ENUMS.get(
            self.pileup_options.alt_aligned_pileup, []
        )
        return enums

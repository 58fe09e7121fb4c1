"""The port's copy of `deepvariant_tpu.labeler.labeled_examples_to_vcf`: host code,
with the same dict and sort orders, so its labels and metrics equal the
JAX package's.

Convert labeled DeepVariant examples into a VCF file.

Capability parity with the reference tool
(labeler/labeled_examples_to_vcf.py:30-234): read training-mode
tf.Examples, coordinate-sort them, keep one representative per locus
(multiple examples exist per multi-allelic site, one per alt
combination), and emit the embedded variant as a VCF record. When the
embedded variant carries no GT, the example's integer `label`
backfills it (0 -> 0/0, 1 -> 0/1, 2 -> 1/1); unlabeled examples are an
error unless --allow_unlabeled_examples, which writes ./. instead.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import Iterable, Iterator, Optional, Tuple

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.io import examples as examples_io
from deepvariant_tpu_torch.io import tfrecord
from deepvariant_tpu_torch.io.fasta import FastaReader
from deepvariant_tpu_torch.io.tabix import build_index
from deepvariant_tpu_torch.io.vcf import VcfWriter, deepvariant_header


def _variant_range_tuple(variant: Variant) -> Tuple[str, int, int]:
    """Coordinate sort key (nucleus variant_utils.variant_range_tuple)."""
    return (variant.reference_name, variant.start, variant.end)


def _gt_from_label(variant: Variant, label: int) -> Tuple[int, int]:
    if label == 0:
        return (0, 0)
    if label == 1:
        return (0, 1)
    if label == 2:
        return (1, 1)
    raise ValueError(
        f"variant at {variant.reference_name}:{variant.start + 1} has an "
        f"invalid label {label}; labels must be 0, 1, or 2"
    )


def examples_to_variants(
    examples_path: str,
    max_records: Optional[int] = None,
    allow_unlabeled: bool = False,
) -> Iterator[Variant]:
    """Yields coordinate-sorted variants from labeled examples.

    One representative example is kept per locus (the reference keeps
    the first after sorting, labeled_examples_to_vcf.py:138-144); its
    GT comes from the embedded variant call, or from the example label
    when the call has no genotype.
    """
    pairs = []
    n = 0
    for path in glob_sharded_inputs(examples_path):
        for rec in tfrecord.read_tfrecords(path):
            if max_records is not None and n >= max_records:
                break
            ex = examples_io.parse_example(rec)
            if ex.variant is None:
                raise ValueError(f"example in {path} has no variant/encoded")
            pairs.append((ex.variant, ex.label))
            n += 1
        if max_records is not None and n >= max_records:
            break

    pairs.sort(key=lambda p: _variant_range_tuple(p[0]))
    for _, group in itertools.groupby(
        pairs, key=lambda p: _variant_range_tuple(p[0])
    ):
        variant, label = next(iter(group))
        call = variant.calls[0] if variant.calls else None
        # nucleus variantcall_utils.has_genotypes: any gt >= 0; a
        # [-1, -1] (uncalled) GT must be backfilled from the label.
        has_gt = bool(call and any(g >= 0 for g in call.genotype))
        if not has_gt:
            if call is None:
                from deepvariant_tpu_torch.core.types import VariantCall

                call = VariantCall()
                variant.calls.append(call)
            if label is not None:
                call.genotype = list(_gt_from_label(variant, label))
            elif allow_unlabeled:
                call.genotype = [-1, -1]
            else:
                raise ValueError(
                    f"variant at {variant.reference_name}:"
                    f"{variant.start + 1} has neither a genotype nor a "
                    "label; this tool only works with labeled examples "
                    "(pass --allow_unlabeled_examples to emit ./.)"
                )
        yield variant


def peek_sample_name(
    variants: Iterator[Variant],
) -> Tuple[str, Iterator[Variant]]:
    """First variant's call_set_name plus an equivalent iterator."""
    try:
        first = next(variants)
    except StopIteration:
        return "UNKNOWN", iter(())
    name = first.calls[0].call_set_name if first.calls else ""
    return name or "UNKNOWN", itertools.chain([first], variants)


def run(
    examples: str,
    ref: str,
    output_vcf: str,
    sample_name: str = "",
    max_records: Optional[int] = None,
    allow_unlabeled: bool = False,
) -> int:
    fasta = FastaReader(ref)
    variants = examples_to_variants(
        examples, max_records=max_records, allow_unlabeled=allow_unlabeled
    )
    if not sample_name:
        sample_name, variants = peek_sample_name(variants)
    header = deepvariant_header(fasta.contigs, [sample_name])
    count = 0
    with VcfWriter(output_vcf, header=header) as writer:
        for variant in variants:
            variant.calls[0].call_set_name = sample_name
            writer.write(variant)
            count += 1
    if output_vcf.endswith(".gz"):
        build_index(output_vcf)
    return count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert labeled DeepVariant examples to a VCF."
    )
    parser.add_argument("--examples", required=True,
                        help="labeled tf.Example TFRecords (sharded ok)")
    parser.add_argument("--ref", required=True,
                        help="reference FASTA (for VCF contig header)")
    parser.add_argument("--output_vcf", required=True)
    parser.add_argument("--sample_name", default="",
                        help="override the embedded call_set_name")
    parser.add_argument("--max_records", type=int, default=-1)
    parser.add_argument("--allow_unlabeled_examples", action="store_true",
                        help="emit ./. for unlabeled examples")
    args = parser.parse_args(argv)
    n = run(
        args.examples,
        args.ref,
        args.output_vcf,
        sample_name=args.sample_name,
        max_records=args.max_records if args.max_records >= 0 else None,
        allow_unlabeled=args.allow_unlabeled_examples,
    )
    print(f"wrote {n} variants to {args.output_vcf}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

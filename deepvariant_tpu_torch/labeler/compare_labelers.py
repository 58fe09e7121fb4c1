"""The port's copy of `deepvariant_tpu.labeler.compare_labelers`: host code,
with the same dict and sort orders, so its labels and metrics equal the
JAX package's.

Compare labels between two sets of labeled examples.

Capability parity with the reference tool
(labeler/compare_labelers.py:30-136): read two TFRecord files of
labeled examples (e.g. one from the haplotype labeler and one from the
combined labeler), key each by variant, and write every variant whose
genotypes differ (order-insensitively) to a text report.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Tuple

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.io import examples as examples_io
from deepvariant_tpu_torch.io import tfrecord

Genotype = Tuple[int, ...]


def variant_key(variant: Variant, sort_alleles: bool = True) -> str:
    """chrom:pos1:ref->alt/alt key (nucleus variant_utils.variant_key)."""
    alts = variant.alternate_bases
    if sort_alleles:
        alts = sorted(alts)
    return (
        f"{variant.reference_name}:{variant.start + 1}:"
        f"{variant.reference_bases}->{'/'.join(alts)}"
    )


def read_example_labels(path: str) -> Dict[str, Genotype]:
    """Map variant_key -> embedded genotype for every example in path."""
    labels: Dict[str, Genotype] = {}
    for shard in glob_sharded_inputs(path):
        for rec in tfrecord.read_tfrecords(shard):
            ex = examples_io.parse_example(rec)
            if ex.variant is None or not ex.variant.calls:
                raise ValueError(
                    f"example in {shard} lacks a genotyped variant"
                )
            labels[variant_key(ex.variant)] = tuple(
                ex.variant.calls[0].genotype
            )
    return labels


def write_differences(
    labels_a: Dict[str, Genotype],
    labels_b: Dict[str, Genotype],
    output_path: str,
) -> int:
    """Write one block per disagreeing variant; returns the diff count."""

    def sorted_or_none(gt: Optional[Genotype]):
        return sorted(gt) if gt is not None else None

    diff_count = 0
    with open(output_path, "w") as out:
        for key in sorted(set(labels_a) | set(labels_b)):
            gt_a, gt_b = labels_a.get(key), labels_b.get(key)
            if sorted_or_none(gt_a) != sorted_or_none(gt_b):
                diff_count += 1
                out.write(f"Variant: {key}\n")
                out.write(f"  Labeler A Genotype: {gt_a}\n")
                out.write(f"  Labeler B Genotype:  {gt_b}\n")
    return diff_count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Diff the labels of two labeled-example TFRecords."
    )
    parser.add_argument("--labeled_examples_a", required=True)
    parser.add_argument("--labeled_examples_b", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    labels_a = read_example_labels(args.labeled_examples_a)
    print(f"read {len(labels_a)} examples from labeler A", file=sys.stderr)
    labels_b = read_example_labels(args.labeled_examples_b)
    print(f"read {len(labels_b)} examples from labeler B", file=sys.stderr)

    n = write_differences(labels_a, labels_b, args.output)
    print(f"found {n} differences; wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

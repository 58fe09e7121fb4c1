"""Render pileup example tensors to PNG images, with filtering and
automated curation.

The port's copy of `deepvariant_tpu.tools.show_examples`: the same
files, TSV and pixels. Its PNGs are written by `vis.write_png`, so it
needs no Pillow unless a header of channel names is drawn (the default
`--annotation`; `--noannotation` draws none).

Reference parity: deepvariant/show_examples.py — the full flag
surface (--vcf/--regions/--filter_by_tsv filters, channels/RGB/both
image types, channel-name annotation from example_info.json or
--column_labels, truth labels in filenames, --curate TSV output,
--write_tfrecords passthrough, --max_examples_to_scan) built on the
tools/vis curation library.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import List, Optional, Sequence, Set

import numpy as np

# Channel enum -> name (deepvariant.proto:1287-1342 subset).
CHANNEL_NAMES = {
    1: "read_base",
    2: "base_quality",
    3: "mapping_quality",
    4: "strand",
    5: "read_supports_variant",
    6: "base_differs_from_ref",
    7: "haplotype_tag",
    8: "allele_frequency",
    9: "diff_channels_alt1",
    10: "diff_channels_alt2",
    19: "insert_size",
    20: "base_channels_alt1",
    21: "base_channels_alt2",
    26: "mean_coverage",
}

MAX_SIZE_TO_PRINT = 5


def channel_panels(image: np.ndarray, pad: int = 2) -> np.ndarray:
    """(H, W, C) uint8 -> single (H, C*(W+pad)) grayscale tile strip."""
    h, w, c = image.shape
    out = np.zeros((h, c * (w + pad)), np.uint8)
    for i in range(c):
        out[:, i * (w + pad): i * (w + pad) + w] = image[..., i]
    return out


def save_example_png(
    image: np.ndarray,
    path: str,
    channels: Optional[Sequence[int]] = None,
    scale: int = 2,
):
    """Write the tiled channel strip as a grayscale PNG (vis.py
    draw_deepvariant_pileup equivalent), with vis's own encoder."""
    from deepvariant_tpu_torch.tools.vis import write_png

    strip = channel_panels(image)
    if scale != 1:
        strip = np.repeat(np.repeat(strip, scale, axis=0), scale, axis=1)
    write_png(strip, path)


def get_short_id(variant, indices: Sequence[int]) -> str:
    """Locus ID for filenames; long alleles become INS/DEL/MNP sizes
    (show_examples.py get_short_id semantics)."""
    pos_prefix = f"{variant.reference_name}:{variant.start}"
    ref = variant.reference_bases
    alts = variant.alternate_bases
    if len(ref) > MAX_SIZE_TO_PRINT or any(
        len(alts[i]) > MAX_SIZE_TO_PRINT for i in indices
    ):
        # When alts share a length, disambiguate with their indices.
        use_alt_indices = len({len(a) for a in alts}) < len(alts)
        alt_types = []
        for i in indices:
            diff = len(alts[i]) - len(ref)
            prefix = f"alt{i}" if use_alt_indices else ""
            if diff < 0:
                kind = f"DEL{-diff}bp"
            elif diff > 0:
                kind = f"INS{diff}bp"
            else:
                kind = f"MNP{len(alts[i])}bp"
            alt_types.append(prefix + kind)
        return f"{pos_prefix}_{'|'.join(alt_types)}"
    alt_strings = [alts[i] for i in indices]
    return f"{pos_prefix}_{ref}->{'|'.join(alt_strings)}"


def parse_vcf_locus_ids(vcf_path: str) -> Set[str]:
    """Locus IDs ('chrom:start0_ref') from a possibly headerless,
    possibly gzipped VCF."""
    opener = gzip.open if vcf_path.endswith(".gz") else open
    ids = set()
    with opener(vcf_path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.split()
            if len(cols) < 4:
                continue
            ids.add(f"{cols[0]}:{int(cols[1]) - 1}_{cols[3]}")
    return ids


def _column_labels(args, examples_path: str) -> Optional[List[str]]:
    if args.column_labels:
        return args.column_labels.split(",")
    info_path = args.example_info_json
    if info_path == "auto":
        import glob as _glob

        found = sorted(_glob.glob(
            os.path.join(os.path.dirname(examples_path) or ".",
                         "*example_info.json")
        ))
        info_path = found[0] if found else None
    if info_path and os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
        return [
            CHANNEL_NAMES.get(ch, f"channel_{ch}")
            for ch in info.get("channels", [])
        ]
    return None


def main(argv=None) -> int:
    import argparse

    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
    from deepvariant_tpu_torch.io import examples as example_codec
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader, TFRecordWriter
    from deepvariant_tpu_torch.tools import vis

    p = argparse.ArgumentParser("show_examples")
    p.add_argument("--examples", required=True)
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--example_info_json", default="auto",
                   help="channels sidecar for column labels "
                        "('auto' finds it next to --examples)")
    p.add_argument("--vcf", default=None,
                   help="only output loci matching this (possibly "
                        "headerless) VCF by chrom/pos/ref")
    p.add_argument("--image_type", default="channels",
                   choices=("channels", "RGB", "both", "none"))
    p.add_argument("--regions", default=None,
                   help="only render examples overlapping these regions")
    p.add_argument("--num_records", type=int, default=None,
                   help="maximum loci to output (after filtering)")
    p.add_argument("--annotation", action="store_true", default=True)
    p.add_argument("--noannotation", dest="annotation",
                   action="store_false")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--truth_labels", action="store_true", default=True)
    p.add_argument("--notruth_labels", dest="truth_labels",
                   action="store_false")
    p.add_argument("--column_labels", default=None,
                   help="comma-separated channel labels")
    p.add_argument("--scale", type=int, default=1)
    p.add_argument("--curate", action="store_true",
                   help="write a TSV of curation tags, one row per "
                        "pileup")
    p.add_argument("--write_tfrecords", action="store_true",
                   help="also write the filtered examples back out")
    p.add_argument("--filter_by_tsv", default=None,
                   help="only output loci whose ID matches column 1 "
                        "of this TSV (e.g. a filtered --curate output)")
    p.add_argument("--max_examples_to_scan", type=int, default=None)
    args = p.parse_args(argv)

    if args.column_labels and args.example_info_json != "auto":
        raise ValueError(
            "set at most one of --column_labels or --example_info_json"
        )
    os.makedirs(args.output, exist_ok=True)

    region_filter = None
    if args.regions:
        from deepvariant_tpu_torch.core.ranges import RangeSet

        region_filter = RangeSet.from_regions(args.regions.split())
    vcf_ids = parse_vcf_locus_ids(args.vcf) if args.vcf else None
    tsv_ids = None
    if args.filter_by_tsv:
        with open(args.filter_by_tsv) as f:
            tsv_ids = {
                line.split("\t")[0].strip() for line in f if line.strip()
            }

    column_labels = _column_labels(args, args.examples)
    make_rgb = args.image_type in ("both", "RGB")
    make_channels = args.image_type in ("both", "channels")

    tfrecord_writer = None
    if args.write_tfrecords:
        tfrecord_writer = TFRecordWriter(
            os.path.join(args.output, "examples.tfrecord.gz")
        )
    curation_rows = []

    num_scanned = 0
    written = 0
    done = False
    for path in glob_sharded_inputs(args.examples):
        if done:
            break
        with TFRecordReader(path) as reader:
            for buf in reader:
                num_scanned += 1
                if (args.max_examples_to_scan is not None
                        and num_scanned > args.max_examples_to_scan):
                    done = True
                    break
                if args.num_records is not None and \
                        written >= args.num_records:
                    done = True
                    break
                ex = example_codec.parse_example(buf)
                v = ex.variant
                indices = list(ex.alt_allele_indices)
                locus_id = vis.locus_id_from_variant(v)
                short_id = get_short_id(v, indices)
                if vcf_ids is not None and locus_id not in vcf_ids:
                    continue
                if tsv_ids is not None and short_id not in tsv_ids:
                    continue
                if region_filter is not None and not \
                        region_filter.variant_overlaps(v):
                    continue
                label = ex.label
                suffix = (
                    f"_label{label}"
                    if args.truth_labels and label is not None else ""
                )
                base = short_id.replace(":", "_").replace(">", "")
                if args.verbose:
                    print(short_id)
                channels = vis.split_3d_array_into_channels(ex.image)
                if make_channels:
                    vis.draw_deepvariant_pileup(
                        channels=channels,
                        annotated=args.annotation,
                        labels=column_labels,
                        scale=args.scale or None,
                        path=os.path.join(
                            args.output, f"{base}{suffix}.png"
                        ),
                    )
                if make_rgb:
                    vis.draw_deepvariant_pileup(
                        channels=channels,
                        composite_type="RGB",
                        annotated=args.annotation,
                        scale=args.scale or None,
                        path=os.path.join(
                            args.output, f"{base}{suffix}.rgb.png"
                        ),
                    )
                if args.curate and len(channels) >= 6:
                    tags = vis.curate_pileup(channels)
                    curation_rows.append((short_id, label, tags))
                if tfrecord_writer is not None:
                    tfrecord_writer.write(buf)
                written += 1

    if tfrecord_writer is not None:
        tfrecord_writer.close()
    if args.curate:
        tsv_path = os.path.join(args.output, "curation.tsv")
        with open(tsv_path, "w") as f:
            f.write(
                "id\tlabel\tBaseQuality\tMappingQuality\tStrandBias"
                "\tDiff\tReadSupport\n"
            )
            for short_id, label, tags in curation_rows:
                f.write("\t".join([
                    short_id, str(label),
                    str(tags.base_quality), str(tags.mapping_quality),
                    str(tags.strand_bias), str(tags.diff_category),
                    str(tags.read_support),
                ]) + "\n")
        print(f"show_examples: curation TSV at {tsv_path}")
    print(
        f"show_examples: scanned {num_scanned}, wrote {written} loci "
        f"to {args.output}"
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

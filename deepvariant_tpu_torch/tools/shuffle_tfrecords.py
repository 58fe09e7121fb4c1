"""Global shuffle of training example TFRecords.

The port's copy of `deepvariant_tpu.tools.shuffle_tfrecords`: host code
over the port's TFRecord and sharded-file modules: the shards and the
dataset config equal the JAX package's byte for byte. Unlike the JAX
tool it removes its bucket directory when it is done.

Reference parity: tools/shuffle_tfrecords_beam.py — the reference uses
Apache Beam with a sha1-of-record sort key for a deterministic global
shuffle; this implementation applies the same sha1 ordering with a
single-machine external sort (bucket by key prefix, sort in-memory per
bucket), writing N output shards plus the DeepVariantDatasetConfig.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from typing import List, Optional

from deepvariant_tpu_torch.core.sharded_files import (
    glob_sharded_inputs,
    sharded_filename,
)
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader, TFRecordWriter
from deepvariant_tpu_torch.training.data import DatasetConfig

_NUM_BUCKETS = 64


def shuffle_tfrecords(
    input_spec: str,
    output_spec: str,
    dataset_config_path: str = "",
    dataset_name: str = "shuffled",
) -> int:
    """Deterministic sha1-ordered shuffle (Beam pipeline equivalent)."""
    from deepvariant_tpu_torch.core.sharded_files import (
        parse_sharded_file_spec,
    )

    parsed = parse_sharded_file_spec(output_spec)
    if parsed:
        base, n_out, suffix = parsed
        out_paths = [
            sharded_filename(base, i, n_out, suffix)
            for i in range(n_out)
        ]
    else:
        out_paths = [output_spec]

    # Pass 1: bucket records by sha1 prefix into temp files.
    tmpdir = tempfile.mkdtemp(prefix="dv_shuffle_")
    buckets = [
        TFRecordWriter(os.path.join(tmpdir, f"bucket-{b:03d}"))
        for b in range(_NUM_BUCKETS)
    ]
    total = 0
    for path in glob_sharded_inputs(input_spec):
        with TFRecordReader(path) as reader:
            for record in reader:
                digest = hashlib.sha1(record).digest()
                buckets[digest[0] % _NUM_BUCKETS].write(record)
                total += 1
    for b in buckets:
        b.close()

    # Pass 2: sort each bucket by full sha1, round-robin to outputs.
    writers = [TFRecordWriter(p) for p in out_paths]
    write_i = 0
    for b in range(_NUM_BUCKETS):
        records = list(TFRecordReader(
            os.path.join(tmpdir, f"bucket-{b:03d}")
        ))
        records.sort(key=lambda r: hashlib.sha1(r).digest())
        for record in records:
            writers[write_i % len(writers)].write(record)
            write_i += 1
    for w in writers:
        w.close()
    shutil.rmtree(tmpdir)

    if dataset_config_path:
        DatasetConfig(
            name=dataset_name,
            tfrecord_path=output_spec,
            num_examples=total,
        ).write(dataset_config_path)
    return total


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("shuffle_tfrecords")
    p.add_argument("--input_pattern_list", required=True)
    p.add_argument("--output_pattern", required=True)
    p.add_argument("--output_dataset_config_pbtxt", default="")
    p.add_argument("--output_dataset_name", default="shuffled")
    args = p.parse_args(argv)
    total = shuffle_tfrecords(
        args.input_pattern_list,
        args.output_pattern,
        args.output_dataset_config_pbtxt,
        args.output_dataset_name,
    )
    print(f"shuffle_tfrecords: {total} records shuffled")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

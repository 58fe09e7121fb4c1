"""Training input pipeline: TFRecord examples -> fixed-shape numpy batches.

The port's copy of `deepvariant_tpu.training.data`, host code with the
same `random.Random(seed)` draws, so its batches equal the JAX
package's byte for byte.

Host-side equivalent of the reference's tf.data pipeline
(data_providers.py:64-250): parse image/label/variant_type, per-class
sample weights, shuffle buffer, repeat, drop-remainder batching. The
device transfer + (x-128)/128 normalization + one-hot happen inside the
train step on the device (same placement as the reference, which
normalizes on-accelerator).

Also reads/writes the DeepVariantDatasetConfig contract
(deepvariant.proto:1080-1096) as a small JSON/pbtxt-text file.
"""

from __future__ import annotations

import dataclasses
import json
import random
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.training.config import TrainConfig


@dataclasses.dataclass
class DatasetConfig:
    """DeepVariantDatasetConfig (deepvariant.proto:1080)."""

    name: str = ""
    tfrecord_path: str = ""
    num_examples: int = 0

    @staticmethod
    def read(path: str) -> "DatasetConfig":
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            d = json.loads(text)
            return DatasetConfig(**d)
        # pbtxt-style: name: "x"\ntfrecord_path: "y"\nnum_examples: N
        cfg = DatasetConfig()
        for key, caster in (("name", str), ("tfrecord_path", str),
                            ("num_examples", int)):
            m = re.search(rf'{key}:\s*"?([^"\n]+)"?', text)
            if m:
                setattr(cfg, key, caster(m.group(1).strip()))
        return cfg

    def write(self, path: str):
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(dataclasses.asdict(self), f)
        else:
            with open(path, "w") as f:
                f.write(f'name: "{self.name}"\n')
                f.write(f'tfrecord_path: "{self.tfrecord_path}"\n')
                f.write(f"num_examples: {self.num_examples}\n")


@dataclasses.dataclass
class Batch:
    images: np.ndarray        # (B, H, W, C) uint8
    labels: np.ndarray        # (B,) int32
    sample_weights: np.ndarray  # (B,) float32
    variant_types: np.ndarray   # (B,) int32


def _iter_parsed(
    paths: Sequence[str],
) -> Iterator[Tuple[np.ndarray, int, int]]:
    for path in paths:
        with TFRecordReader(path) as reader:
            for buf in reader:
                ex = example_codec.parse_example(buf)
                yield (
                    ex.image,
                    int(ex.label or 0),
                    int(ex.variant_type or 0),
                )


def input_fn(
    tfrecord_path: str,
    config: TrainConfig,
    mode: str = "train",
    seed: Optional[int] = None,
) -> Iterator[Batch]:
    """Yield shuffled, repeated, fixed-size batches (drop remainder).

    mode='train': shuffle + repeat forever. mode='tune': one pass,
    in order, final partial batch dropped (as the reference's
    drop_remainder=True does).
    """
    paths = glob_sharded_inputs(tfrecord_path)
    class_weights = config.class_weight_list()
    rng = random.Random(config.seed if seed is None else seed)
    batch_size = config.batch_size

    def weighted(label: int) -> float:
        if class_weights and 0 <= label < len(class_weights):
            return class_weights[label]
        return 1.0

    def emit(buf_items) -> Batch:
        images, labels, vtypes = zip(*buf_items)
        labels = np.asarray(labels, np.int32)
        return Batch(
            images=np.stack(images),
            labels=labels,
            sample_weights=np.asarray(
                [weighted(l) for l in labels], np.float32
            ),
            variant_types=np.asarray(vtypes, np.int32),
        )

    if mode == "train":
        buffer: List[Tuple[np.ndarray, int, int]] = []
        pending: List[Tuple[np.ndarray, int, int]] = []
        while True:
            order = list(paths)
            rng.shuffle(order)
            for item in _iter_parsed(order):
                buffer.append(item)
                if len(buffer) >= config.shuffle_buffer_elements:
                    # Pop a uniformly random element (shuffle buffer).
                    idx = rng.randrange(len(buffer))
                    buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                    pending.append(buffer.pop())
                    if len(pending) == batch_size:
                        yield emit(pending)
                        pending = []
            # Drain the buffer at epoch end, keep repeating files.
            rng.shuffle(buffer)
            for item in buffer:
                pending.append(item)
                if len(pending) == batch_size:
                    yield emit(pending)
                    pending = []
            buffer = []
    else:
        pending = []
        for item in _iter_parsed(paths):
            pending.append(item)
            if len(pending) == batch_size:
                yield emit(pending)
                pending = []
        if pending:
            # Pad the final partial batch to the static batch size with
            # zero-weight copies of the last example; the tune step
            # masks weight-0 rows out of loss and confusion counts.
            # (The reference's drop_remainder=True silently scores
            # nothing when the tune set is smaller than one batch.)
            n_real = len(pending)
            batch = emit(
                pending + [pending[-1]] * (batch_size - n_real)
            )
            batch.sample_weights[n_real:] = 0.0
            yield batch

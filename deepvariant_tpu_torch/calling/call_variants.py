"""Stage 2: call_variants — batched CNN genotype inference on the card.

Counterpart of `deepvariant_tpu/calling/call_variants.py`:

  * Static shapes: batches are padded to `batch_size`, so every step
    runs the same convolutions with the same shapes.
  * Host-to-device overlap: each batch is stacked into a pinned host
    buffer and copied with `non_blocking=True` on a side stream while
    earlier batches compute; at most `prefetch` batches are in flight,
    and results come back in order through pinned buffers.
  * Probabilities are rounded like the reference's `round_gls`
    (call_variants.py:248-263) before the CVO is written.
  * Several devices (the MirroredStrategy of call_variants.py:782, JAX's
    data-sharded jit): `Predictor(devices=...)` cuts each batch into one
    contiguous part per device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from deepvariant_tpu_torch.core.genomics_math import round_gls
from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.core.types import (CallVariantsOutput,
                                              CvoDebugInfo, Variant)
from deepvariant_tpu_torch.device import full_float32_precision, resolve_device
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader, TFRecordWriter
from deepvariant_tpu_torch.models.inception_v3 import (
    InceptionV3,
    fold_batch_norm,
    normalize_pileup,
    pad_stem_input_channels,
    prepare_for_inference,
)


@dataclasses.dataclass
class ExampleRecord:
    """One parsed pileup example awaiting classification."""

    image: np.ndarray  # (H, W, C) uint8
    variant: Variant
    alt_allele_indices: List[int]
    label: Optional[int] = None  # training examples only


def iter_examples(paths: Sequence[str]) -> Iterator[ExampleRecord]:
    for path in paths:
        with TFRecordReader(path) as reader:
            for buf in reader:
                ex = example_codec.parse_example(buf)
                yield ExampleRecord(
                    image=ex.image,
                    variant=ex.variant,
                    alt_allele_indices=ex.alt_allele_indices,
                    label=ex.label,
                )


def check_example_info(
    examples_path: str, expected_shape: Sequence[int],
    expected_channels: Optional[Sequence[int]] = None,
) -> None:
    """Shape/channel contract check (call_variants.py:648-746 parity)."""
    info_path = examples_path + ".example_info.json"
    if not os.path.exists(info_path):
        return
    with open(info_path) as f:
        info = json.load(f)
    if list(info.get("shape", [])) != list(expected_shape):
        raise ValueError(
            f"example_info shape {info.get('shape')} != model input "
            f"shape {list(expected_shape)}"
        )
    if expected_channels is not None and "channels" in info:
        if list(info["channels"]) != list(expected_channels):
            raise ValueError("channel enum mismatch vs example_info.json")


# ---------------------------------------------------------------------------
# Moving batches to the device and results back, in order
# ---------------------------------------------------------------------------

class BatchStager:
    """Host-to-device copies of stacked batches through pinned buffers.

    `stage({name: [array, ...]})` stacks each list into a pinned buffer
    (one set per slot, reused round-robin) and copies it to the device
    on a side stream; the current stream waits for the copy before the
    caller's work on the tensors. A slot is refilled only after its
    previous copy has finished. On the CPU it just stacks."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self._buffers: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(slots)]
        self._copied: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0
        self._stream = torch.cuda.Stream(device) if self.cuda else None

    def stage(self, parts: Dict[str, List[np.ndarray]]
              ) -> Dict[str, torch.Tensor]:
        if not self.cuda:
            return {k: torch.from_numpy(np.stack(v)) for k, v in parts.items()}
        slot = self._next
        self._next = (slot + 1) % len(self._buffers)
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        buffers = self._buffers[slot]
        for name, arrays in parts.items():
            shape = (len(arrays),) + arrays[0].shape
            dtype = torch.from_numpy(np.empty(0, arrays[0].dtype)).dtype
            buf = buffers.get(name)
            if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
                buffers[name] = buf
            np.stack(arrays, out=buf.numpy())
        out = {}
        with torch.cuda.stream(self._stream):
            for name in parts:
                out[name] = buffers[name].to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        self._copied[slot] = copied
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(self._stream)
        for t in out.values():
            t.record_stream(current)
        return out


class PendingResult:
    """A (B, k) float32 device result on its way back to the host."""

    def __init__(self, result: torch.Tensor):
        if result.device.type == "cuda":
            self._host = torch.empty(result.shape, dtype=result.dtype,
                                     pin_memory=True)
            self._host.copy_(result, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host, self._done = result, None

    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


def predict_in_order(
    items: Iterable,
    batch_size: int,
    submit: Callable[[list], PendingResult],
    prefetch: int = 2,
) -> Iterator[Tuple[object, np.ndarray]]:
    """Batch `items`, `submit` each batch, keep up to `prefetch` batches
    in flight, and yield (item, result row) in input order."""
    inflight: collections.deque = collections.deque()

    def batches():
        buf = []
        for item in items:
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf:
            yield buf

    gen = batches()
    for batch in gen:
        inflight.append((batch, submit(batch)))
        if len(inflight) >= prefetch:
            break
    while inflight:
        batch, pending = inflight.popleft()
        nxt = next(gen, None)
        if nxt is not None:
            inflight.append((nxt, submit(nxt)))
        result = pending.numpy()[: len(batch)]
        for item, row in zip(batch, result):
            yield item, row


class _InOrder:
    """The parts of one batch's result, each on its way back from its
    device, joined in order."""

    def __init__(self, parts: List[PendingResult]):
        self._parts = parts

    def numpy(self) -> np.ndarray:
        return np.concatenate([p.numpy() for p in self._parts])


class _Replica:
    """One device's share of each batch: the model on that device, the
    stream it runs on (None: the caller's current stream) and its own
    stager."""

    def __init__(self, model: InceptionV3, device: torch.device,
                 keep: Optional[torch.Tensor], own_stream: bool):
        self.model = model
        self.device = device
        self.keep = keep
        self.stream = torch.cuda.Stream(device) if own_stream else None
        self.stager = BatchStager(device, slots=3)

    def on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


class Predictor:
    """InceptionV3 forward over uint8 pileups, on one device or several.

    `devices` defaults to every visible card when `device` is CUDA
    without an index (JAX: `jax.devices()`), else to `device`. Over n
    devices the batch size is rounded as the JAX Predictor rounds it
    (`b - b % n or n`), each padded batch is cut into n contiguous parts,
    and part i runs on device i's replica of the model (its weights
    copied once per device) on its own stream, staged by its own
    `BatchStager`; the parts' results are joined in order."""

    def __init__(
        self,
        model: InceptionV3,
        batch_size: int = 512,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        ablation_channels: Optional[Sequence[int]] = None,
        fold_bn: bool = False,
        pad_stem_to: Optional[int] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        device = resolve_device(device)
        full_float32_precision()
        if fold_bn:
            # Export-time BN folding: conv + bias + relu, exact to float32
            # rounding.
            model = fold_batch_norm(model)
        self.pad_stem_to = None
        if pad_stem_to and model.num_channels < pad_stem_to:
            # Zero-pad the stem's input channels (exact) and pad the
            # images to match on the device.
            model = pad_stem_input_channels(model, pad_stem_to)
            self.pad_stem_to = pad_stem_to
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if device.type == "cuda" and device.index is None
                       else [device])
        devices = [resolve_device(d) for d in devices]
        self.device = devices[0]
        self.dtype = dtype
        n = len(devices)
        self.batch_size = batch_size - batch_size % n or n
        models: Dict[torch.device, InceptionV3] = {}
        self.replicas = []
        for i, d in enumerate(devices):
            if d not in models:
                models[d] = prepare_for_inference(model, d, dtype)
            keep = None
            if ablation_channels:
                keep = torch.tensor(list(ablation_channels),
                                    dtype=torch.int64, device=d)
            own_stream = i > 0 and d.type == "cuda"
            self.replicas.append(_Replica(models[d], d, keep, own_stream))

    @property
    def model(self) -> InceptionV3:
        return self.replicas[0].model

    @property
    def stager(self) -> BatchStager:
        """The first device's stager (two batches in flight and one being
        filled)."""
        return self.replicas[0].stager

    @torch.inference_mode()
    def forward(self, images_u8: torch.Tensor,
                replica: Optional[_Replica] = None) -> torch.Tensor:
        """(B, H, W, C) uint8 on a device -> (B, 3) float32 probs, by the
        replica on that device (the first device's by default)."""
        r = replica or self.replicas[0]
        x = normalize_pileup(images_u8, self.dtype)
        if r.keep is not None:
            x = x.index_select(-1, r.keep)
        if self.pad_stem_to and x.shape[-1] < self.pad_stem_to:
            x = torch.nn.functional.pad(
                x, (0, self.pad_stem_to - x.shape[-1]))
        return r.model(x)

    def _in_parts(self, part_images) -> Union[PendingResult, _InOrder]:
        """Runs each replica on `part_images(i, replica)`, its part of the
        batch on its device, called on its stream."""
        parts = []
        for i, r in enumerate(self.replicas):
            with r.on_stream():
                parts.append(PendingResult(
                    self.forward(part_images(i, r), r)))
        return parts[0] if len(parts) == 1 else _InOrder(parts)

    def _submit_images(self, images: List[np.ndarray]):
        pad = self.batch_size - len(images)
        if pad > 0:
            images = list(images) + [np.zeros_like(images[0])] * pad
        size = self.batch_size // len(self.replicas)
        return self._in_parts(lambda i, r: r.stager.stage(
            {"images": images[i * size:(i + 1) * size]})["images"])

    def submit_device_images(self, images_u8: torch.Tensor):
        """(batch_size, H, W, C) uint8 images on the first device, made on
        its current stream -> the pending (batch_size, 3) probabilities.
        Each replica's part is copied to its device on its stream, after
        the work that made the images."""
        size = self.batch_size // len(self.replicas)
        made_on = (torch.cuda.current_stream(images_u8.device)
                   if images_u8.is_cuda else None)

        def part(i, r):
            piece = images_u8[i * size:(i + 1) * size]
            if r.stream is None:
                return piece
            r.stream.wait_stream(made_on)
            images_u8.record_stream(r.stream)
            return piece.to(r.device, non_blocking=True)

        return self._in_parts(part)

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        """(B, H, W, C) uint8 numpy, B <= batch_size -> (B, 3) probs."""
        return self._submit_images(list(images_u8)).numpy()[
            : len(images_u8)].copy()

    def predict_stream(
        self,
        records: Iterable[ExampleRecord],
        prefetch: int = 2,
    ) -> Iterator[Tuple[ExampleRecord, np.ndarray]]:
        """Yield (record, probs[3]) with up to `prefetch` batches in flight."""
        return predict_in_order(
            records, self.batch_size,
            lambda batch: self._submit_images([r.image for r in batch]),
            prefetch,
        )


def _debug_info(rec: ExampleRecord, gls: Sequence[float]) -> CvoDebugInfo:
    """DebugInfo under --include_debug_info (reference
    call_variants.py:373-388 via variant_utils)."""
    v = rec.variant
    ref_len = len(v.reference_bases)
    alts = v.alternate_bases
    return CvoDebugInfo(
        predicted_label=int(np.argmax(gls)),
        has_insertion=any(len(a) > ref_len for a in alts),
        has_deletion=any(len(a) < ref_len for a in alts),
        is_snp=ref_len == 1 and all(len(a) == 1 for a in alts),
        true_label=int(rec.label) if rec.label is not None else 0,
    )


def call_variants(
    examples_path: str,
    output_path: str,
    model: InceptionV3,
    batch_size: int = 512,
    device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    ablation_channels: Optional[Sequence[int]] = None,
    writer_cls=TFRecordWriter,
    num_writers: int = 1,
    include_debug_info: bool = False,
    limit: int = 0,
    max_batches: int = 0,
    fast_graph: bool = False,
) -> dict:
    """Run inference over sharded example TFRecords, write CVO TFRecords.

    num_writers > 1 drains predictions through a round-robin pool of
    writer processes, each owning one `-KKKKK-of-NNNNN` output shard
    (calling/cvo_writer.py); readers take the base path and glob the
    family. `fast_graph` folds batch norm and pads the stem to 8
    channels.

    Returns {"num_examples": N, "examples_per_sec": r,
             "output_paths": [...]}.
    """
    paths = glob_sharded_inputs(examples_path)
    predictor = Predictor(
        model,
        batch_size=batch_size,
        device=device,
        dtype=dtype,
        ablation_channels=ablation_channels,
        fold_bn=fast_graph,
        pad_stem_to=8 if fast_graph else None,
    )
    n = 0
    start = time.time()
    # --limit / --max_batches (reference call_variants.py:199,124):
    # hard caps on examples processed.
    cap = limit if limit > 0 else 0
    if max_batches > 0:
        batch_cap = max_batches * predictor.batch_size
        cap = min(cap, batch_cap) if cap else batch_cap

    def capped(records):
        for i, item in enumerate(records):
            if cap and i >= cap:
                break
            yield item

    stream = predictor.predict_stream(capped(iter_examples(paths)))
    if num_writers > 1:
        from deepvariant_tpu_torch.calling.cvo_writer import CvoWriterPool

        pool = CvoWriterPool(output_path, num_writers)
        out_paths = pool.paths
        buf = []
        try:
            for rec, probs in stream:
                buf.append((rec.variant, rec.alt_allele_indices,
                            [float(p) for p in probs]))
                n += 1
                if len(buf) >= predictor.batch_size:
                    pool.put_batch(buf)
                    buf = []
            if buf:
                pool.put_batch(buf)
        finally:
            written = pool.close()
        if written != n:
            raise RuntimeError(
                f"writer pool wrote {written} CVOs, expected {n}"
            )
    else:
        out_paths = [output_path]
        with writer_cls(output_path) as writer:
            for rec, probs in stream:
                gls = round_gls([float(p) for p in probs])
                cvo = CallVariantsOutput(
                    variant=rec.variant,
                    alt_allele_indices=rec.alt_allele_indices,
                    genotype_probabilities=gls,
                    debug_info=(
                        _debug_info(rec, gls) if include_debug_info else None
                    ),
                )
                writer.write(cvo.encode())
                n += 1
    dt = max(time.time() - start, 1e-9)
    return {"num_examples": n, "examples_per_sec": n / dt,
            "output_paths": out_paths}


def read_cvos(path: str) -> Iterator[CallVariantsOutput]:
    for p in glob_sharded_inputs(path):
        with TFRecordReader(p) as reader:
            for buf in reader:
                yield CallVariantsOutput.decode(buf)

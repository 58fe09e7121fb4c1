"""tf.Example wire codec + the pileup-example schema.

tf.Example is protobuf: Example{1: Features{1: map<string, Feature>}},
Feature = oneof{1: BytesList, 2: FloatList, 3: Int64List}, each with
`value = 1` (bytes repeated / packed floats / packed varints).

Schema written by make_examples (reference make_examples_native.cc:426-464):
  locus                       bytes  "chr:start-end" (1-based region string)
  variant/encoded             bytes  serialized Variant
  variant_type                int64  (0 unknown / 1 snp / 2 indel)
  alt_allele_indices/encoded  bytes  serialized CallVariantsOutput.AltAlleleIndices
  image/encoded               bytes  raw uint8 H*W*C
  image/shape                 int64 x3
  sequencing_type             int64
  label / denovo_label        int64  (training only)

Sidecar `<path>.example_info.json`: {version, shape, channels:[enum ints]}
(make_examples_core.py:3766-3774).

The port's copy of `deepvariant_tpu.io.examples`; the bytes it writes
are identical to that module's.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from deepvariant_tpu_torch.core import protowire as pw
from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.core.types import Variant

FeatureValue = Union[bytes, List[bytes], List[int], List[float]]


def encode_feature(value: FeatureValue) -> bytes:
    if isinstance(value, bytes):
        value = [value]
    if not isinstance(value, (list, tuple)) or not value:
        if isinstance(value, (list, tuple)):
            return pw.field_message(3, b"")  # empty int64 list
        raise TypeError(f"bad feature value: {value!r}")
    first = value[0]
    if isinstance(first, bytes):
        payload = b"".join(pw.field_bytes(1, v) for v in value)
        return pw.field_message(1, payload)
    if isinstance(first, str):
        payload = b"".join(pw.field_string(1, v) for v in value)
        return pw.field_message(1, payload)
    if isinstance(first, float):
        return pw.field_message(2, pw.packed_floats(1, value))
    return pw.field_message(
        3, pw.packed_varints(1, [v & ((1 << 64) - 1) if v < 0 else v
                                 for v in value])
    )


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    entries = []
    for key, value in features.items():
        entry = pw.field_string(1, key) + pw.field_message(
            2, encode_feature(value)
        )
        entries.append(pw.field_message(1, entry))
    return pw.field_message(1, b"".join(entries))


def decode_example(buf: bytes) -> Dict[str, list]:
    """Decode tf.Example -> {name: list of bytes|int|float}."""
    out: Dict[str, list] = {}
    for num, _, val in pw.iter_fields(buf):
        if num != 1:
            continue
        for fnum, _, fval in pw.iter_fields(val):
            if fnum != 1:
                continue
            key, values = "", []
            for enum_, _, eval_ in pw.iter_fields(fval):
                if enum_ == 1:
                    key = bytes(eval_).decode()
                elif enum_ == 2:
                    for tnum, twt, tval in pw.iter_fields(eval_):
                        if tnum == 1:  # BytesList
                            values = [
                                bytes(v)
                                for n2, _, v in pw.iter_fields(tval)
                                if n2 == 1
                            ]
                        elif tnum == 2:  # FloatList
                            for n2, wt2, v in pw.iter_fields(tval):
                                if n2 == 1:
                                    if wt2 == pw.WIRETYPE_LEN:
                                        values = pw.decode_packed_floats(v)
                                    else:
                                        values.append(
                                            pw.decode_fixed32_float(v)
                                        )
                        elif tnum == 3:  # Int64List
                            for n2, wt2, v in pw.iter_fields(tval):
                                if n2 == 1:
                                    if wt2 == pw.WIRETYPE_LEN:
                                        values = [
                                            pw.varint_to_signed64(x)
                                            for x in
                                            pw.decode_packed_varints(v)
                                        ]
                                    else:
                                        values.append(
                                            pw.varint_to_signed64(v)
                                        )
            out[key] = values
    return out


# ---------------------------------------------------------------------------
# Pileup example helpers
# ---------------------------------------------------------------------------

def encode_alt_allele_indices(indices: List[int]) -> bytes:
    """CallVariantsOutput.AltAlleleIndices wire format (repeated int32=1)."""
    return pw.packed_varints(1, indices)


def decode_alt_allele_indices(buf: bytes) -> List[int]:
    out: List[int] = []
    for num, wt, val in pw.iter_fields(buf):
        if num == 1:
            if wt == pw.WIRETYPE_LEN:
                out.extend(pw.decode_packed_varints(val))
            else:
                out.append(val)
    return out


# EncodedVariantType (dv_utils semantics): 0=unknown, 1=snp, 2=indel.
VARIANT_TYPE_UNKNOWN = 0
VARIANT_TYPE_SNP = 1
VARIANT_TYPE_INDEL = 2


def variant_type_of(variant: Variant) -> int:
    """make_examples_native.cc:301-320 EncodedVariantType."""
    if len(variant.reference_bases) == 1 and variant.alternate_bases:
        if all(len(a) == 1 for a in variant.alternate_bases):
            return VARIANT_TYPE_SNP
    if len(variant.reference_bases) > 1:
        return VARIANT_TYPE_INDEL
    if any(len(a) > 1 for a in variant.alternate_bases):
        return VARIANT_TYPE_INDEL
    return VARIANT_TYPE_UNKNOWN


def make_example(
    variant: Variant,
    image: np.ndarray,
    alt_allele_indices: List[int],
    locus_region: str,
    sequencing_type: int = 0,
    label: Optional[int] = None,
    denovo_label: Optional[int] = None,
) -> bytes:
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(
            f"image must be (H, W, C) uint8, got {image.dtype} {image.shape}"
        )
    features: Dict[str, FeatureValue] = {
        "locus": locus_region.encode(),
        "variant/encoded": variant.encode(),
        "variant_type": [variant_type_of(variant)],
        "alt_allele_indices/encoded": encode_alt_allele_indices(
            alt_allele_indices
        ),
        "image/encoded": image.tobytes(),
        "image/shape": list(image.shape),
        "sequencing_type": [sequencing_type],
    }
    if label is not None:
        features["label"] = [label]
    if denovo_label is not None:
        features["denovo_label"] = [denovo_label]
    return encode_example(features)


class DecodedExample:
    """Structured view of a decoded pileup example."""

    def __init__(self, feats: Dict[str, list]):
        self.features = feats
        shape = feats.get("image/shape", [])
        self.shape = tuple(int(s) for s in shape)
        raw = feats.get("image/encoded", [b""])[0]
        self.image = (
            np.frombuffer(raw, np.uint8).reshape(self.shape)
            if self.shape and raw
            else None
        )
        venc = feats.get("variant/encoded", [b""])[0]
        self.variant = Variant.decode(venc) if venc else None
        aenc = feats.get("alt_allele_indices/encoded", [b""])[0]
        self.alt_allele_indices = (
            decode_alt_allele_indices(aenc) if aenc else []
        )
        self.locus = (
            feats.get("locus", [b""])[0].decode()
            if feats.get("locus")
            else ""
        )
        self.label = (
            int(feats["label"][0]) if feats.get("label") else None
        )
        self.variant_type = (
            int(feats["variant_type"][0])
            if feats.get("variant_type")
            else None
        )


def parse_example(buf: bytes) -> DecodedExample:
    return DecodedExample(decode_example(buf))


def example_image_shape(feats: Dict[str, list]) -> List[int]:
    """The image/shape of a decoded example; raises when the field is
    absent or malformed (dv_utils.example_image_shape)."""
    shape = feats.get("image/shape", [])
    if len(shape) != 3:
        raise ValueError(
            "example lacks a length-3 image/shape field: "
            f"{sorted(feats)}"
        )
    return [int(x) for x in shape]


def shape_from_examples_path(spec: str) -> Optional[List[int]]:
    """image/shape of the first example under `spec` — a plain path,
    an `@N` sharded spec, or a glob; None when every resolved file is
    empty (dv_utils.get_shape_from_examples_path, dv_utils.py:190-214).
    Unresolvable paths raise."""
    from deepvariant_tpu_torch.io import tfrecord

    resolved = glob_sharded_inputs(spec)
    if not resolved:
        raise FileNotFoundError(
            f"no examples matched: {spec}"
        )
    for path in resolved:
        for rec in tfrecord.read_tfrecords(path):
            return example_image_shape(decode_example(rec))
    return None


# ---------------------------------------------------------------------------
# example_info.json sidecar
# ---------------------------------------------------------------------------

EXAMPLE_INFO_VERSION = "1.10.0"  # data-contract version we match


def write_example_info(
    path: str, shape: Tuple[int, int, int], channels: List[int]
):
    info = {
        "version": EXAMPLE_INFO_VERSION,
        "shape": list(shape),
        "channels": list(channels),
    }
    with open(path + ".example_info.json", "w") as f:
        json.dump(info, f)


def read_example_info(path: str) -> dict:
    # Resolve '@N' specs / globs to the first shard's sidecar.
    resolved = glob_sharded_inputs(path)
    first = resolved[0] if resolved else path
    candidates = [first + ".example_info.json",
                  path + ".example_info.json"]
    if not path.endswith(".json"):
        candidates.append(path)
    for cand in candidates:
        try:
            with open(cand) as f:
                return json.load(f)
        except (FileNotFoundError, IsADirectoryError):
            continue
    raise FileNotFoundError(f"no example_info.json next to {path}")

"""Minimal protobuf wire-format codec.

We do not depend on the protobuf runtime or on generated code. The framework's
native data model is plain Python dataclasses + numpy arrays; this module
provides just enough of the proto wire format to (a) read/write tf.Example
records and (b) round-trip the small set of genomics messages (Variant, Read,
Range, CallVariantsOutput) whose serialized form is the on-disk contract shared
with the reference pipeline (reference: make_examples_native.cc:426-464 writes
`variant/encoded` as a serialized Variant).

Wire format (public spec): a message is a sequence of (tag, value) where
tag = (field_number << 3) | wire_type. Wire types used here:
  0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple, Union

WIRETYPE_VARINT = 0
WIRETYPE_FIXED64 = 1
WIRETYPE_LEN = 2
WIRETYPE_FIXED32 = 5


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def encode_varint(value: int) -> bytes:
    """Encode a non-negative int (or two's-complement 64-bit) as a varint."""
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def encode_tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def encode_zigzag(value: int) -> int:
    return (value << 1) ^ (value >> 63)


def field_varint(field_number: int, value: int) -> bytes:
    return encode_tag(field_number, WIRETYPE_VARINT) + encode_varint(value)


def field_bool(field_number: int, value: bool) -> bytes:
    return field_varint(field_number, 1 if value else 0)


def field_bytes(field_number: int, value: bytes) -> bytes:
    return (
        encode_tag(field_number, WIRETYPE_LEN)
        + encode_varint(len(value))
        + value
    )


def field_string(field_number: int, value: str) -> bytes:
    return field_bytes(field_number, value.encode("utf-8"))


def field_double(field_number: int, value: float) -> bytes:
    return encode_tag(field_number, WIRETYPE_FIXED64) + struct.pack(
        "<d", value
    )


def field_float(field_number: int, value: float) -> bytes:
    return encode_tag(field_number, WIRETYPE_FIXED32) + struct.pack(
        "<f", value
    )


def field_message(field_number: int, encoded: bytes) -> bytes:
    return field_bytes(field_number, encoded)


def packed_varints(field_number: int, values) -> bytes:
    payload = b"".join(encode_varint(v) for v in values)
    return field_bytes(field_number, payload)


def packed_doubles(field_number: int, values) -> bytes:
    payload = struct.pack("<%dd" % len(values), *values)
    return field_bytes(field_number, payload)


def packed_floats(field_number: int, values) -> bytes:
    payload = struct.pack("<%df" % len(values), *values)
    return field_bytes(field_number, payload)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

def decode_varint(buf: Union[bytes, memoryview], pos: int) -> Tuple[int, int]:
    """Decode a varint at pos; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def varint_to_signed64(value: int) -> int:
    """Interpret an unsigned varint as a two's-complement int64."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def decode_zigzag(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def iter_fields(
    buf: Union[bytes, memoryview],
) -> Iterator[Tuple[int, int, Union[int, bytes, memoryview]]]:
    """Iterate (field_number, wire_type, raw_value) over a serialized message.

    For varints the raw value is the unsigned int; for fixed32/64 the packed
    little-endian bytes; for length-delimited a memoryview of the payload.
    """
    mv = memoryview(buf)
    pos = 0
    end = len(mv)
    while pos < end:
        tag, pos = decode_varint(mv, pos)
        field_number = tag >> 3
        wire_type = tag & 7
        if wire_type == WIRETYPE_VARINT:
            value, pos = decode_varint(mv, pos)
        elif wire_type == WIRETYPE_FIXED64:
            value = bytes(mv[pos : pos + 8])
            pos += 8
        elif wire_type == WIRETYPE_LEN:
            length, pos = decode_varint(mv, pos)
            value = mv[pos : pos + length]
            pos += length
        elif wire_type == WIRETYPE_FIXED32:
            value = bytes(mv[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_number, wire_type, value


def decode_packed_varints(payload: Union[bytes, memoryview]):
    values = []
    pos = 0
    n = len(payload)
    while pos < n:
        v, pos = decode_varint(payload, pos)
        values.append(v)
    return values


def decode_fixed64_double(raw: bytes) -> float:
    return struct.unpack("<d", raw)[0]


def decode_fixed32_float(raw: bytes) -> float:
    return struct.unpack("<f", raw)[0]


def decode_packed_doubles(payload: Union[bytes, memoryview]):
    n = len(payload) // 8
    return list(struct.unpack("<%dd" % n, bytes(payload)))


def decode_packed_floats(payload: Union[bytes, memoryview]):
    n = len(payload) // 4
    return list(struct.unpack("<%df" % n, bytes(payload)))

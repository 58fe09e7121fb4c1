"""The msgpack subset that `flax.serialization` writes, read and written
without the `msgpack` package.

flax saves a checkpoint as msgpack: maps with string keys, strings,
ints, floats, booleans, nil, and arrays as ext type 1, whose payload is
itself msgpack of (shape, dtype name, raw C-order bytes); numpy scalars
are ext type 3 with the same payload. Arrays over 1 GiB are split into
`__msgpack_chunked_array__` maps. `unpack` returns nested dicts of
numpy arrays and Python values; `pack` writes the same layout, which
`flax.serialization.msgpack_restore` reads back.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":  # no numpy dtype; widened exactly on load
        return np.dtype(np.uint16)
    return np.dtype(name)


def _array(payload: bytes) -> np.ndarray:
    shape, name, raw = unpack(payload)
    if isinstance(name, bytes):
        name = name.decode()
    arr = np.frombuffer(raw, dtype=_dtype(name)).reshape(shape)
    if name == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.copy()


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _array(payload)
    if code == EXT_NPSCALAR:
        return _array(payload)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(value):
    if isinstance(value, dict):
        if value.get("__msgpack_chunked_array__"):
            shape = tuple(value["shape"][str(i)]
                          for i in range(len(value["shape"])))
            chunks = [value["chunks"][str(i)]
                      for i in range(len(value["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in value.items()}
    return value


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def fmt(self, f: str):
        return struct.unpack(">" + f, self.take(struct.calcsize(f)))[0]

    def value(self) -> Any:
        t = self.fmt("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        lengths = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if t in lengths:
            return self.take(self.fmt(lengths[t]))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.fmt({0xC7: "B", 0xC8: "H", 0xC9: "I"}[t])
            code = self.fmt("b")
            return _ext(code, self.take(n))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in numbers:
            return self.fmt(numbers[t])
        if 0xD4 <= t <= 0xD8:
            code = self.fmt("b")
            return _ext(code, self.take(1 << (t - 0xD4)))
        if t in (0xD9, 0xDA, 0xDB):
            return self.take(self.fmt({0xD9: "B", 0xDA: "H",
                                       0xDB: "I"}[t])).decode()
        if t in (0xDC, 0xDD):
            return self.array(self.fmt("H" if t == 0xDC else "I"))
        if t in (0xDE, 0xDF):
            return self.map(self.fmt("H" if t == 0xDE else "I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpack(buf: bytes) -> Any:
    """Decode one msgpack object (flax's subset), arrays as numpy."""
    reader = _Reader(buf)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(out)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _len_header(n: int, fix: Tuple[int, int], codes: Tuple[int, ...],
                fmts: Tuple[str, ...]) -> bytes:
    base, limit = fix
    if base is not None and n < limit:
        return bytes([base | n])
    for code, f in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(f)):
            return bytes([code]) + struct.pack(">" + f, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_ext(code: int, payload: bytes) -> bytes:
    return (_len_header(len(payload), (None, 0), (0xC7, 0xC8, 0xC9),
                        ("B", "H", "I"))
            + struct.pack(">b", code) + payload)


def _pack_array_payload(arr: np.ndarray) -> bytes:
    return pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def pack(value: Any) -> bytes:
    """Encode dicts (string keys), lists, str, bytes, int, float, bool,
    None and numpy arrays and scalars as flax does."""
    if value is None:
        return b"\xc0"
    if isinstance(value, np.ndarray):
        return _pack_ext(EXT_NDARRAY, _pack_array_payload(value))
    if isinstance(value, np.generic):
        return _pack_ext(EXT_NPSCALAR, _pack_array_payload(np.asarray(value)))
    if isinstance(value, bool):
        return b"\xc3" if value else b"\xc2"
    if isinstance(value, int):
        if 0 <= value <= 0x7F:
            return bytes([value])
        if -32 <= value < 0:
            return struct.pack(">b", value)
        if value >= 0:
            for code, f in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"),
                            (0xCF, "Q")):
                if value < 1 << (8 * struct.calcsize(f)):
                    return bytes([code]) + struct.pack(">" + f, value)
        for code, f in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q")):
            bits = 8 * struct.calcsize(f) - 1
            if -(1 << bits) <= value < (1 << bits):
                return bytes([code]) + struct.pack(">" + f, value)
        raise ValueError(f"integer {value} does not fit msgpack")
    if isinstance(value, float):
        return b"\xcb" + struct.pack(">d", value)
    if isinstance(value, str):
        raw = value.encode()
        return _len_header(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB),
                           ("B", "H", "I")) + raw
    if isinstance(value, (bytes, bytearray)):
        return _len_header(len(value), (None, 0), (0xC4, 0xC5, 0xC6),
                           ("B", "H", "I")) + bytes(value)
    if isinstance(value, (list, tuple)):
        return _len_header(len(value), (0x90, 16), (0xDC, 0xDD),
                           ("H", "I")) + b"".join(pack(v) for v in value)
    if isinstance(value, dict):
        out = [_len_header(len(value), (0x80, 16), (0xDE, 0xDF), ("H", "I"))]
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack map keys must be str, got {k!r}")
            out.append(pack(k))
            out.append(pack(v))
        return b"".join(out)
    raise TypeError(f"cannot msgpack-encode {type(value).__name__}")

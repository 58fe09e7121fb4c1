"""TFRecord reader/writer (with gzip), no TensorFlow dependency.

Format (public): each record is
  uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)
where masked_crc = ((crc >> 15) | (crc << 17)) + 0xa282ead8 (mod 2^32) and the
CRC is CRC-32C (Castagnoli). Equivalent of nucleus tfrecord_{reader,writer}.h.

A copy of `deepvariant_tpu.io.tfrecord` without its native CRC library:
CRC-32C here is numpy slicing-by-8. A record of a few kilobytes or more
is cut into a power of two of equal lanes whose CRCs are computed side
by side (numpy over the lanes) and folded pairwise with the GF(2)
operator of a run of zero bytes (the linearity zlib's crc32_combine
uses); the rest, and short records, run the byte loop. Readers skip the
CRC check by default, so only writing large records pays it.
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO, Iterator, List, Optional, Union

import numpy as np

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs

_POLY = 0x82F63B78  # reflected CRC-32C polynomial


def _make_tables() -> List[np.ndarray]:
    tables = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        tables[0, i] = crc
    for t in range(1, 8):
        for i in range(256):
            c = tables[t - 1, i]
            tables[t, i] = (c >> 8) ^ tables[0, c & 0xFF]
    return [tables[k] for k in range(8)]


_T = _make_tables()


# The lanes of a long record: each about this many bytes, at most
# _MAX_LANES of them.
_LANE_BYTES = 256
_MAX_LANES = 4096


def _operator_tables(columns: np.ndarray) -> np.ndarray:
    """(4, 256) byte tables of the GF(2) operator whose image of bit i
    is columns[i]."""
    tables = np.zeros((4, 256), np.uint32)
    for k in range(4):
        for j in range(8):
            tables[k, 1 << j:2 << j] = tables[k, :1 << j] ^ columns[8 * k + j]
    return tables


def _apply(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (tables[0][x & 0xFF] ^ tables[1][(x >> 8) & 0xFF]
            ^ tables[2][(x >> 16) & 0xFF] ^ tables[3][x >> 24])


def _make_zero_powers() -> List[np.ndarray]:
    """Byte tables of the CRC register's map over 2**k zero bytes."""
    ones = np.uint32(1) << np.arange(32, dtype=np.uint32)
    columns = (ones >> 8) ^ _T[0][ones & 0xFF]      # one zero byte
    powers = []
    for _ in range(40):
        tables = _operator_tables(columns)
        powers.append(tables)
        columns = _apply(tables, columns)
    return powers


_ZERO_POWERS = _make_zero_powers()


def _zero_bytes_columns(n: int) -> np.ndarray:
    """The columns of the register's map over `n` zero bytes."""
    columns = np.uint32(1) << np.arange(32, dtype=np.uint32)
    k = 0
    while n:
        if n & 1:
            columns = _apply(_ZERO_POWERS[k], columns)
        n >>= 1
        k += 1
    return columns


def _lane_crcs(words: np.ndarray) -> np.ndarray:
    """The CRC registers, from 0, of each lane of `words` (lanes, steps,
    2) little-endian uint32, slicing-by-8 over the lanes at once."""
    t7, t6, t5, t4, t3, t2, t1, t0 = (_T[k] for k in range(7, -1, -1))
    crc = np.zeros(words.shape[0], np.uint32)
    for s in range(words.shape[1]):
        x = crc ^ words[:, s, 0]
        y = words[:, s, 1]
        crc = (t7[x & 0xFF] ^ t6[(x >> 8) & 0xFF] ^ t5[(x >> 16) & 0xFF]
               ^ t4[x >> 24] ^ t3[y & 0xFF] ^ t2[(y >> 8) & 0xFF]
               ^ t1[(y >> 16) & 0xFF] ^ t0[y >> 24])
    return crc


def _crc_lanes(buf: np.ndarray, crc: int):
    """(the register after the lanes, the bytes they leave) of a long
    record: CRC(A || B) = Z^len(B)(CRC(A)) ^ CRC_0(B), folded pairwise."""
    lanes = 1 << min(_MAX_LANES.bit_length() - 1,
                     (len(buf) // _LANE_BYTES).bit_length() - 1)
    lane = len(buf) // lanes // 8 * 8
    words = np.ascontiguousarray(buf[:lanes * lane]).view("<u4").reshape(
        lanes, lane // 8, 2)
    parts = _lane_crcs(words)
    columns = _zero_bytes_columns(lane)
    while len(parts) > 1:
        tables = _operator_tables(columns)
        parts = _apply(tables, parts[0::2]) ^ parts[1::2]
        columns = _apply(tables, columns)       # twice the width
    start = _apply(_operator_tables(columns), np.array([crc], np.uint32))
    return int(start[0] ^ parts[0]), buf[lanes * lane:]


def crc32c(data: bytes, crc: int = 0) -> int:
    """Slicing-by-8 CRC-32C."""
    crc = crc ^ 0xFFFFFFFF
    buf = np.frombuffer(data, np.uint8)
    if len(buf) >= 16 * _LANE_BYTES:
        crc, buf = _crc_lanes(buf, crc)
    n8 = len(buf) // 8
    if n8 > 0:
        chunk = buf[: n8 * 8].reshape(n8, 8)
        t7, t6, t5, t4, t3, t2, t1, t0 = (_T[k] for k in range(7, -1, -1))
        cc = int(crc)
        for row in range(n8):
            b = chunk[row]
            x = cc ^ (int(b[0]) | (int(b[1]) << 8) | (int(b[2]) << 16)
                      | (int(b[3]) << 24))
            cc = int(
                t7[x & 0xFF] ^ t6[(x >> 8) & 0xFF] ^ t5[(x >> 16) & 0xFF]
                ^ t4[(x >> 24) & 0xFF] ^ t3[b[4]] ^ t2[b[5]] ^ t1[b[6]]
                ^ t0[b[7]]
            )
        crc = cc
    tab = _T[0]
    for b in buf[n8 * 8 :]:
        crc = (crc >> 8) ^ int(tab[(crc ^ int(b)) & 0xFF])
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _open(path: str, mode: str) -> BinaryIO:
    if path.endswith(".gz") or ".gz-" in path or ".gz@" in path:
        return gzip.open(path, mode)  # type: ignore[return-value]
    return open(path, mode)


class TFRecordWriter:
    def __init__(self, path: str):
        self._fh = _open(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", masked_crc(header)))
        self._fh.write(record)
        self._fh.write(struct.pack("<I", masked_crc(record)))

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    def __init__(self, path: str, verify_crc: bool = False):
        self._fh = _open(path, "rb")
        self._verify = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        while True:
            header = self._fh.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if self._verify:
                (hcrc,) = struct.unpack("<I", header[8:12])
                if masked_crc(header[:8]) != hcrc:
                    raise ValueError("corrupt TFRecord length crc")
            data = self._fh.read(length)
            if len(data) < length:
                raise ValueError("truncated TFRecord")
            tail = self._fh.read(4)
            if self._verify:
                (dcrc,) = struct.unpack("<I", tail)
                if masked_crc(data) != dcrc:
                    raise ValueError("corrupt TFRecord data crc")
            yield data

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(
    path_or_paths: Union[str, List[str]], max_records: Optional[int] = None
) -> Iterator[bytes]:
    """Iterate records across one path, a list, or a sharded spec."""
    if isinstance(path_or_paths, str):
        paths = glob_sharded_inputs(path_or_paths)
    else:
        paths = []
        for p in path_or_paths:
            paths.extend(glob_sharded_inputs(p))
    count = 0
    for p in paths:
        with TFRecordReader(p) as reader:
            for rec in reader:
                yield rec
                count += 1
                if max_records is not None and count >= max_records:
                    return

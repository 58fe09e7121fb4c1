"""BGZF (blocked gzip) reader/writer in pure Python on top of zlib.

BGZF is the container for BAM/.vcf.gz/.fa.gz(+.gzi): a series of gzip members,
each <= 64KiB uncompressed, each carrying a BC extra subfield with the
compressed block size, terminated by a fixed 28-byte EOF member. Virtual file
offsets pack (compressed_block_offset << 16 | within_block_offset), which is
how BAI/tabix indexes address records.

The reference gets this from htslib; this is a from-scratch implementation of
the public format (SAM spec section 4.1). A C++ fast path can replace the
decompression loop later without changing callers.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import BinaryIO, Iterator, Optional, Tuple

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK_UNCOMPRESSED = 65280


def _parse_block_header(header: bytes) -> int:
    """Return BSIZE (total compressed block length) from an 18+ byte header."""
    if header[:2] != b"\x1f\x8b":
        raise ValueError("not a gzip block")
    xlen = struct.unpack_from("<H", header, 10)[0]
    # Scan extra subfields for BC.
    pos = 12
    end = 12 + xlen
    while pos + 4 <= end:
        si1, si2, slen = header[pos], header[pos + 1], struct.unpack_from(
            "<H", header, pos + 2
        )[0]
        if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
            bsize = struct.unpack_from("<H", header, pos + 4)[0]
            return bsize + 1
        pos += 4 + slen
    raise ValueError("gzip block without BGZF BC subfield")


class BgzfReader:
    """Random-access BGZF reader with virtual-offset seeks.

    Maintains a one-block cache; sequential `read` crosses blocks.
    """

    # Decompressed blocks kept per reader (LRU).  Adjacent range
    # queries (BAI/tabix chunks) re-enter the same boundary blocks
    # constantly; 256 x 64KiB = 16MiB cap.
    _CACHE_BLOCKS = 256

    def __init__(self, path_or_file, io_threads: int = 0):
        """io_threads > 0 enables a host inflation pool (the htslib
        bgzf-threads analog, samtools -@): on a cache miss the next
        blocks' compressed bytes are read inline (cheap) and their
        zlib inflations run on the pool — zlib releases the GIL, so
        sequential scans overlap decompression across cores."""
        if isinstance(path_or_file, (str, bytes)):
            self._fh: BinaryIO = open(path_or_file, "rb")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        from collections import OrderedDict

        self._cache: "OrderedDict[int, Tuple[bytes, int]]" = OrderedDict()
        self._block_coffset = -1
        self._block_data = b""
        self._within = 0
        self._next_coffset = 0
        self._pool = None
        self._pending: dict = {}
        self._readahead = 0
        self._frontier = 0
        if io_threads > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=io_threads, thread_name_prefix="bgzf"
            )
            self._readahead = io_threads * 4
        self._load_block(0)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            self._pending.clear()
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- block management ------------------------------------------------------

    def _load_block(self, coffset: int, sequential: bool = False) -> bool:
        """Load the block at compressed offset; returns False at EOF.
        `sequential` marks streaming consumption (read()/read_all),
        the only access pattern where pool readahead pays for itself —
        random BAI-chunk hops skip it."""
        if coffset == self._block_coffset:
            return True
        cached = self._cache.get(coffset)
        if cached is not None:
            self._cache.move_to_end(coffset)
            data, next_coffset = cached
            self._block_coffset = coffset
            self._block_data = data
            self._next_coffset = next_coffset
            self._within = 0
            return len(data) > 0 or (next_coffset - coffset) > 28
        fut = self._pending.pop(coffset, None)
        if fut is not None:
            data, next_coffset = fut.result()
            self._insert_cache(coffset, data, next_coffset)
            self._block_coffset = coffset
            self._block_data = data
            self._next_coffset = next_coffset
            self._within = 0
            if sequential:
                self._schedule_readahead(next_coffset)
            return len(data) > 0 or (next_coffset - coffset) > 28
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) == 0:
            self._block_coffset = coffset
            self._block_data = b""
            self._next_coffset = coffset
            return False
        if len(header) < 18:
            raise ValueError("truncated BGZF block header")
        bsize = _parse_block_header(header)
        rest = self._fh.read(bsize - 18)
        comp = header + rest
        # Strip gzip wrapper: wbits=-15 raw deflate after the header;
        # the 18-byte fixed header is standard for BGZF blocks.
        data = zlib.decompress(comp[18:-8], wbits=-15)
        self._block_coffset = coffset
        self._block_data = data
        self._next_coffset = coffset + bsize
        self._within = 0
        self._insert_cache(coffset, data, self._next_coffset)
        if sequential:
            self._schedule_readahead(self._next_coffset)
        return len(data) > 0 or bsize > 28

    def _insert_cache(self, coffset: int, data: bytes,
                      next_coffset: int) -> None:
        self._cache[coffset] = (data, next_coffset)
        if len(self._cache) > max(self._CACHE_BLOCKS, self._readahead):
            self._cache.popitem(last=False)

    def _schedule_readahead(self, coffset: int) -> None:
        """Read upcoming blocks' compressed bytes inline and hand their
        inflations to the pool (no file IO on worker threads). A
        sliding frontier keeps the window `_readahead` blocks deep for
        sequential scans; a far seek resets it (dropping stale
        futures' results, not waiting on them)."""
        if self._pool is None:
            return
        window_bytes = (self._readahead + 2) << 16
        if (coffset > self._frontier
                or coffset + window_bytes < self._frontier):
            self._frontier = coffset
            if len(self._pending) > 2 * self._readahead:
                self._pending.clear()
        while len(self._pending) < self._readahead:
            c = self._frontier
            cached = self._cache.get(c)
            if cached is not None:
                nxt = cached[1]
                if nxt == c:
                    break
                self._frontier = nxt
                continue
            if c in self._pending:
                # Next offset unknown until its inflation is consumed.
                break
            self._fh.seek(c)
            header = self._fh.read(18)
            if len(header) < 18:
                break
            try:
                bsize = _parse_block_header(header)
            except ValueError:
                break
            comp = header + self._fh.read(bsize - 18)
            if len(comp) < bsize:
                break
            next_coffset = c + bsize

            def inflate(body=comp, nxt=next_coffset):
                return zlib.decompress(body[18:-8], wbits=-15), nxt

            self._pending[c] = self._pool.submit(inflate)
            self._frontier = next_coffset

    # -- virtual offsets -------------------------------------------------------

    @property
    def virtual_offset(self) -> int:
        return (self._block_coffset << 16) | self._within

    def seek_virtual(self, voffset: int):
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        self._load_block(coffset)
        self._within = within

    # -- reading ---------------------------------------------------------------

    def read(self, n: int) -> bytes:
        out = []
        need = n
        while need > 0:
            avail = len(self._block_data) - self._within
            if avail <= 0:
                if not self._load_block(
                    self._next_coffset, sequential=True
                ) and not self._block_data:
                    break
                if not self._block_data:
                    # Empty block (possibly EOF marker); try next.
                    prev = self._block_coffset
                    if not self._load_block(
                        self._next_coffset, sequential=True
                    ):
                        break
                    if self._block_coffset == prev:
                        break
                continue
            take = min(avail, need)
            out.append(self._block_data[self._within : self._within + take])
            self._within += take
            need -= take
        return b"".join(out)

    def read_exact(self, n: int) -> bytes:
        data = self.read(n)
        if len(data) != n:
            raise EOFError(f"wanted {n} bytes, got {len(data)}")
        return data

    def read_span(self, beg_vo: int, end_vo: int,
                  tail_margin: int = 1 << 17):
        """(decompressed bytes, main_len): bytes from beg_vo running to
        exactly end_vo (main_len of them) plus `tail_margin` extra —
        a BAM record STARTING before end_vo may extend past it, so the
        scanner consumes records whose start offset is < main_len and
        uses the tail to finish the last one."""
        self.seek_virtual(beg_vo)
        chunks = []
        main_len = 0
        end_coff = end_vo >> 16
        end_within = end_vo & 0xFFFF
        while True:
            if self._block_coffset == end_coff:
                take = max(0, end_within - self._within)
                chunks.append(
                    self._block_data[self._within:self._within + take]
                )
                main_len += take
                self._within += take
                break
            avail = len(self._block_data) - self._within
            if avail > 0:
                chunks.append(self._block_data[self._within:])
                main_len += avail
                self._within = len(self._block_data)
            if not self._load_block(self._next_coffset):
                break
            if self._block_coffset > end_coff:
                break
            if not self._block_data and self.at_eof():
                break
        if tail_margin > 0:
            chunks.append(self.read(tail_margin))
        return b"".join(chunks), main_len

    def read_all(self) -> bytes:
        chunks = []
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks)

    def at_eof(self) -> bool:
        if self._within < len(self._block_data):
            return False
        # Peek at next block.
        pos = self._next_coffset
        self._fh.seek(pos)
        probe = self._fh.read(1)
        if not probe:
            return True
        # There is more compressed data; check it decompresses to something.
        cur = (self._block_coffset, self._within)
        had = self._load_block(pos)
        if not had and not self._block_data:
            return True
        if len(self._block_data) == 0:
            return self.at_eof()
        self._within = 0
        return False


def read_gzi(path: str):
    """Parse a .gzi index: (n, 2) int64 array of (compressed_offset,
    uncompressed_offset) block starts, with the implicit (0, 0) first
    block prepended (htslib bgzf_index_dump format: u64 count then
    count little-endian u64 pairs)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    (count,) = struct.unpack_from("<Q", data, 0)
    pairs = np.frombuffer(
        data, dtype="<u8", count=2 * count, offset=8
    ).reshape(-1, 2).astype(np.int64)
    out = np.zeros((count + 1, 2), np.int64)
    out[1:] = pairs
    return out


def decompress_range(path: str, index, ustart: int, uend: int) -> bytes:
    """Inflate only the BGZF blocks covering uncompressed byte range
    [ustart, uend) using a .gzi index (read_gzi). Returns exactly
    uend - ustart bytes (short only at physical EOF)."""
    import numpy as np

    if uend <= ustart:
        return b""
    uoffs = index[:, 1]
    first = int(np.searchsorted(uoffs, ustart, side="right")) - 1
    first = max(first, 0)
    out = []
    produced = int(uoffs[first])
    with open(path, "rb") as f:
        f.seek(int(index[first, 0]))
        while produced < uend:
            header = f.read(18)
            if len(header) < 18:
                break
            bsize = _parse_block_header(header)
            body = f.read(bsize - 18)
            cdata = body[: bsize - 26]
            chunk = zlib.decompress(cdata, -15)
            out.append(chunk)
            produced += len(chunk)
            if len(chunk) == 0:  # EOF marker block
                break
    data = b"".join(out)
    rel = ustart - int(uoffs[first])
    return data[rel : rel + (uend - ustart)]


def decompress_all(path: str) -> bytes:
    """Decompress an entire BGZF (or plain gzip) file."""
    with open(path, "rb") as f:
        raw = f.read()
    out = []
    pos = 0
    d = zlib.decompressobj(wbits=47)  # auto-detect gzip members
    while pos < len(raw):
        out.append(d.decompress(raw[pos:]))
        pos = len(raw) - len(d.unused_data)
        if d.eof and pos < len(raw):
            d = zlib.decompressobj(wbits=47)
        elif d.eof:
            break
        else:
            break
    return b"".join(out)


class BgzfWriter:
    """Writes BGZF blocks (with BC subfield) and the EOF marker on close."""

    def __init__(self, path_or_file, compresslevel: int = 6):
        if isinstance(path_or_file, (str, bytes)):
            self._fh: BinaryIO = open(path_or_file, "wb")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        self._buf = bytearray()
        self._level = compresslevel
        self._closed = False
        self._coffset = 0  # compressed bytes written so far

    @property
    def virtual_offset(self) -> int:
        """Current BGZF virtual offset (coffset << 16 | uoffset) —
        the position the *next* write lands at; used by tabix."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK_UNCOMPRESSED:
            self._flush_block(
                bytes(self._buf[:MAX_BLOCK_UNCOMPRESSED])
            )
            del self._buf[:MAX_BLOCK_UNCOMPRESSED]

    def _flush_block(self, data: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(data) + co.flush()
        bsize = len(comp) + 18 + 8
        if bsize > 65536:
            raise ValueError("BGZF block too large after compression")
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)  # XLEN
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
        self._fh.write(header + comp + footer)
        self._coffset += bsize

    def flush(self):
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.flush()

    def close(self):
        if self._closed:
            return
        self.flush()
        self._fh.write(BGZF_EOF)
        self._fh.flush()
        if self._owns:
            self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        header = f.read(18)
    if len(header) < 18 or header[:2] != b"\x1f\x8b":
        return False
    try:
        _parse_block_header(header)
        return True
    except ValueError:
        return False

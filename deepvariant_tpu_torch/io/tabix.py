"""Tabix (.tbi) index writer for BGZF-compressed VCF files.

The port's copy of `deepvariant_tpu.io.tabix`: the same index bytes.

Nucleus parity: tabix_indexer.{h,cc} / htslib tbx_index_build — after
postprocess writes a .vcf.gz, `build_index` produces the .tbi so
downstream tools (bcftools, IGV, hap.py) can random-access it.

Format per the tabix spec (samtools.github.io/hts-specs/tabix.pdf):
BGZF-compressed payload of binning + linear indices over virtual file
offsets. We re-scan the written VCF block structure to recover each
record's virtual offset.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from deepvariant_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

TBI_MAGIC = b"TBI\x01"
# Preset: VCF (format 2), seq col 1, begin col 2, end col 0, meta '#'.
VCF_PRESET = (2, 1, 2, 0, ord("#"), 0)
_LINEAR_SHIFT = 14  # 16kb linear index windows


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _iter_lines_with_voffsets(path: str):
    """Yield (virtual_offset_of_line_start, line_text) from a bgzf file.

    Walks blocks directly so every line start gets the exact
    (block_coffset << 16 | in_block_offset) virtual offset htslib
    would assign."""
    reader = BgzfReader(path)
    # Collect (coffset, data) per block in order.
    blocks = []
    coffset = 0
    while True:
        if not reader._load_block(coffset):
            break
        data = reader._block_data
        nxt = reader._next_coffset
        if data:
            blocks.append((coffset, data))
        if nxt == coffset:
            break
        coffset = nxt
    reader.close()
    # Walk lines across blocks tracking the block/offset of each start.
    cur_block = 0
    cur_off = 0
    line_parts = []
    line_start_vo = (blocks[0][0] << 16) if blocks else 0
    while cur_block < len(blocks):
        bco, data = blocks[cur_block]
        idx = data.find(b"\n", cur_off)
        if idx < 0:
            line_parts.append(data[cur_off:])
            cur_block += 1
            cur_off = 0
            continue
        line_parts.append(data[cur_off:idx])
        yield line_start_vo, b"".join(line_parts).decode()
        line_parts = []
        cur_off = idx + 1
        if cur_off >= len(data):
            cur_block += 1
            cur_off = 0
            if cur_block < len(blocks):
                line_start_vo = blocks[cur_block][0] << 16
        else:
            line_start_vo = (bco << 16) | cur_off
    tail = b"".join(line_parts)
    if tail:
        yield line_start_vo, tail.decode()


CSI_MAGIC = b"CSI\x01"
_CSI_MIN_SHIFT = 14
_CSI_DEPTH = 5
# Level offsets for min_shift=14, depth=5 (identical binning to .tbi):
# cumulative (8^l - 1) / 7.
_CSI_LEVEL_OFFSETS = (0, 1, 9, 73, 585, 4681)


def _csi_bin_first_window(bin_id: int) -> int:
    """First 16kb linear window covered by `bin_id` (min_shift=14,
    depth=5 binning)."""
    for level in range(len(_CSI_LEVEL_OFFSETS) - 1, -1, -1):
        t = _CSI_LEVEL_OFFSETS[level]
        if bin_id >= t:
            shift = _CSI_MIN_SHIFT + 3 * (_CSI_DEPTH - level)
            return ((bin_id - t) << shift) >> _LINEAR_SHIFT
    return 0


def build_index(
    vcf_gz_path: str, output_path: str = "", use_csi: bool = False
) -> str:
    """Build a .tbi (or .csi with `use_csi`, for contigs beyond 2^29 —
    postprocess_variants.py build_index use_csi) for a
    bgzip-compressed VCF. Returns the index path."""
    output_path = output_path or (
        vcf_gz_path + (".csi" if use_csi else ".tbi")
    )
    names: List[str] = []
    name_to_id: Dict[str, int] = {}
    # Per-ref: bin -> list[(chunk_beg, chunk_end)], linear window -> vo.
    bins: List[Dict[int, List[Tuple[int, int]]]] = []
    linear: List[Dict[int, int]] = []
    prev_vo = None
    prev_ref = -1
    last_record_end_vo = 0
    for vo, line in _iter_lines_with_voffsets(vcf_gz_path):
        if prev_vo is not None and prev_ref >= 0:
            # Close the previous record's chunk at this line's offset.
            _close_chunk(bins[prev_ref], prev_chunk_bin, prev_vo, vo)
        prev_vo = None
        if not line or line.startswith("#"):
            continue
        fields = line.split("\t", 8)
        chrom = fields[0]
        pos = int(fields[1]) - 1
        ref_len = len(fields[3]) if len(fields) > 3 else 1
        end = pos + ref_len
        # END INFO override for gVCF blocks.
        if len(fields) > 7 and "END=" in fields[7]:
            for item in fields[7].split(";"):
                if item.startswith("END="):
                    end = int(item[4:])
                    break
        rid = name_to_id.get(chrom)
        if rid is None:
            rid = len(names)
            name_to_id[chrom] = rid
            names.append(chrom)
            bins.append({})
            linear.append({})
        b = _reg2bin(pos, end)
        prev_vo = vo
        prev_ref = rid
        prev_chunk_bin = b
        # Linear index: minimal voffset per 16kb window.
        for win in range(pos >> _LINEAR_SHIFT,
                         ((max(end, pos + 1) - 1) >> _LINEAR_SHIFT) + 1):
            if win not in linear[rid] or vo < linear[rid][win]:
                linear[rid][win] = vo
        last_record_end_vo = vo
    # Close the final chunk at EOF voffset (use a large sentinel based on
    # the last record's offset; htslib uses the file end offset).
    if prev_vo is not None and prev_ref >= 0:
        _close_chunk(bins[prev_ref], prev_chunk_bin, prev_vo,
                     prev_vo + (1 << 16))

    concat_names = b"".join(n.encode() + b"\x00" for n in names)
    payload = bytearray()
    if use_csi:
        # CSI v1 (htslib hts.c hts_idx_save CSI layout): the linear
        # index is replaced by a per-bin loffset seek hint.
        payload += CSI_MAGIC
        payload += struct.pack("<ii", _CSI_MIN_SHIFT, _CSI_DEPTH)
        aux = struct.pack("<7i", *VCF_PRESET, len(concat_names))
        aux += concat_names
        payload += struct.pack("<i", len(aux))
        payload += aux
        payload += struct.pack("<i", len(names))
        for rid in range(len(names)):
            payload += struct.pack("<i", len(bins[rid]))
            for bin_id in sorted(bins[rid]):
                chunks = _merge_chunks(bins[rid][bin_id])
                # loffset: linear-index value at the bin's first
                # window (first record at/after the bin's start).
                win = _csi_bin_first_window(bin_id)
                later = [
                    vo for w, vo in linear[rid].items() if w >= win
                ]
                loffset = min(later) if later else min(
                    beg for beg, _ in chunks
                )
                payload += struct.pack(
                    "<IQi", bin_id, loffset, len(chunks)
                )
                for beg, end in chunks:
                    payload += struct.pack("<QQ", beg, end)
    else:
        payload += TBI_MAGIC
        payload += struct.pack("<i", len(names))
        payload += struct.pack("<6i", *VCF_PRESET)
        payload += struct.pack("<i", len(concat_names))
        payload += concat_names
        for rid in range(len(names)):
            payload += struct.pack("<i", len(bins[rid]))
            for bin_id in sorted(bins[rid]):
                chunks = _merge_chunks(bins[rid][bin_id])
                payload += struct.pack("<Ii", bin_id, len(chunks))
                for beg, end in chunks:
                    payload += struct.pack("<QQ", beg, end)
            if linear[rid]:
                n_win = max(linear[rid]) + 1
                payload += struct.pack("<i", n_win)
                prev = 0
                for win in range(n_win):
                    if win in linear[rid]:
                        prev = linear[rid][win]
                    payload += struct.pack("<Q", prev)
            else:
                payload += struct.pack("<i", 0)
    with BgzfWriter(output_path) as writer:
        writer.write(bytes(payload))
    return output_path


def _close_chunk(bin_map, bin_id, beg, end):
    bin_map.setdefault(bin_id, []).append((beg, end))


def _merge_chunks(chunks):
    """Merge adjacent chunks (same boundaries) to keep the index small."""
    merged = []
    for beg, end in sorted(chunks):
        if merged and merged[-1][1] >= beg:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((beg, end))
    return merged


def _reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (tabix spec)."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585),
                         (14, 4681)):
        bins.extend(range(offset + (beg >> shift),
                          offset + (end >> shift) + 1))
    return bins


class TabixReader:
    """Query a tabix-indexed (b)gzipped text file (htslib tbx parity).

    Works with .tbi files produced by this module or by htslib/bcftools.
    """

    def __init__(self, data_path: str, index_path: str = ""):
        self.data_path = data_path
        if not index_path:
            index_path = data_path + ".tbi"
            import os as _os

            if not _os.path.exists(index_path) and _os.path.exists(
                data_path + ".csi"
            ):
                index_path = data_path + ".csi"
        raw = BgzfReader(index_path).read_all()
        if raw[:4] == CSI_MAGIC:
            self._init_csi(raw, index_path)
            return
        if raw[:4] != TBI_MAGIC:
            raise ValueError(f"{index_path}: not a tabix index")
        off = 4
        (n_ref, fmt, col_seq, col_beg, col_end, meta, skip,
         l_nm) = struct.unpack_from("<8i", raw, off)
        off += 32
        names = raw[off:off + l_nm].split(b"\x00")[:-1]
        off += l_nm
        self.names = [n.decode() for n in names]
        self.preset = (fmt, col_seq, col_beg, col_end, meta, skip)
        self._bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self._linear: List[List[int]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bin_map: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", raw, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", raw, off)
                    off += 16
                    chunks.append((beg, end))
                bin_map[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", raw, off)
            off += 4
            intv = list(struct.unpack_from(f"<{n_intv}Q", raw, off))
            off += 8 * n_intv
            self._bins.append(bin_map)
            self._linear.append(intv)

    def _init_csi(self, raw: bytes, index_path: str) -> None:
        """Parse a CSI v1 tabix index (same binning as .tbi at the
        default min_shift=14/depth=5; loffset seek hints replace the
        linear index)."""
        min_shift, depth, l_aux = struct.unpack_from("<3i", raw, 4)
        if (min_shift, depth) != (_CSI_MIN_SHIFT, _CSI_DEPTH):
            raise ValueError(
                f"{index_path}: unsupported CSI geometry "
                f"min_shift={min_shift} depth={depth}"
            )
        off = 16
        aux = raw[off:off + l_aux]
        off += l_aux
        (fmt, col_seq, col_beg, col_end, meta, skip,
         l_nm) = struct.unpack_from("<7i", aux, 0)
        names = aux[28:28 + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        self.preset = (fmt, col_seq, col_beg, col_end, meta, skip)
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        self._bins = []
        self._linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bin_map: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, _loffset, n_chunk = struct.unpack_from(
                    "<IQi", raw, off
                )
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", raw, off)
                    off += 16
                    chunks.append((beg, end))
                bin_map[bin_id] = chunks
            self._bins.append(bin_map)
            self._linear.append([])  # chunk voffsets bound the scan

    def query(self, reference_name: str, start: int, end: int):
        """Yield text lines of records overlapping [start, end)."""
        try:
            rid = self.names.index(reference_name)
        except ValueError:
            return
        bin_map = self._bins[rid]
        chunks: List[Tuple[int, int]] = []
        for bin_id in _reg2bins(start, end):
            chunks.extend(bin_map.get(bin_id, ()))
        if not chunks:
            return
        # Linear-index lower bound prunes chunks entirely before start.
        intv = self._linear[rid]
        min_vo = intv[min(start >> _LINEAR_SHIFT, len(intv) - 1)] \
            if intv else 0
        chunks = _merge_chunks(
            [(b, e) for b, e in chunks if e > min_vo]
        )
        reader = BgzfReader(self.data_path)
        col_seq = self.preset[1] - 1
        col_beg = self.preset[2] - 1
        for chunk_beg, chunk_end in chunks:
            reader.seek_virtual(chunk_beg)
            buf = b""
            while reader.virtual_offset < chunk_end or buf:
                data = reader.read(65536)
                if not data and not buf:
                    break
                buf += data
                while True:
                    idx = buf.find(b"\n")
                    if idx < 0:
                        break
                    line = buf[:idx].decode()
                    buf = buf[idx + 1:]
                    fields = line.split("\t")
                    if fields[col_seq] != reference_name:
                        continue
                    pos = int(fields[col_beg]) - 1
                    rec_end = pos + (
                        len(fields[3]) if len(fields) > 3 else 1
                    )
                    if len(fields) > 7 and "END=" in fields[7]:
                        for item in fields[7].split(";"):
                            if item.startswith("END="):
                                rec_end = int(item[4:])
                                break
                    if pos < end and rec_end > start:
                        yield line
                    if pos >= end:
                        return
                if not data:
                    break
        reader.close()

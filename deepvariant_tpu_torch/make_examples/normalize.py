"""Read-level indel left-alignment (--normalize_reads).

The port's copy of `deepvariant_tpu.make_examples.normalize`, Python on
the host as there. It re-implements the reference allele counter's NormalizeCigar path
(allelecounter.cc:558-871): INS/DEL cigar operations shift left while
the indel's trailing base equals the base preceding it (the standard
variant-normalization recurrence,
genome.sph.umich.edu/wiki/Variant_Normalization), zero-length ops are
swept, adjacent same-type ops merge, DEL+INS pairs collapse into
match + remainder, and a heading indel adjusts the alignment start
(read_shift).

Operates on the columnar ReadBatch in place before allele counting so
the normalized alignments also feed realigner-less pileups, matching
the reference flow where the normalized cigar replaces the read's
alignment (make_examples_core.py:2903-2936).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# nucleus CigarUnit codes.
_M, _I, _D, _N, _S, _H, _P, _EQ, _X = 1, 2, 3, 4, 5, 6, 7, 8, 9
_MATCH_OPS = (_M, _EQ, _X)


def _is_match(op: int) -> bool:
    return op in _MATCH_OPS


def _merge_two(c1: List[int], c2: List[int]) -> bool:
    """MergeOperations (allelecounter.cc:558-586). Mutates in place."""
    op1, n1 = c1
    op2, n2 = c2
    if op1 == op2 or (_is_match(op1) and _is_match(op2)):
        c1[1] = n1 + n2
        c2[1] = 0
        return True
    if op1 in (_I, _D) and op2 in (_I, _D):
        short = min(n1, n2)
        rest = max(n1, n2) - short
        if n1 > n2:
            c2[0] = op1
        c1[0] = _M
        c1[1] = short
        c2[1] = rest
        return True
    return False


def _swipe_and_merge(cigar: List[List[int]]) -> bool:
    """SwipeAndMerge (allelecounter.cc:706-730)."""
    modified = False
    merged = True
    while merged:
        merged = False
        before = len(cigar)
        cigar[:] = [c for c in cigar if c[1] != 0]
        if len(cigar) < before:
            modified = True
        for i in range(len(cigar) - 1):
            if _merge_two(cigar[i], cigar[i + 1]):
                merged = True
                modified = True
                break
    return modified


def _handle_heading_indel(cigar: List[List[int]], idx: int) -> int:
    """HandleHeadingIndel (allelecounter.cc:624-641)."""
    if idx >= len(cigar):
        return 0
    op, n = cigar[idx]
    if op == _D:
        del cigar[idx]
        return n
    if op == _I:
        cigar[idx][0] = _M
        return -n
    return 0


def normalize_cigar(
    read_seq: np.ndarray,
    interval_offset: int,
    cigar: List[Tuple[int, int]],
    ref_bases: np.ndarray,
) -> Tuple[List[Tuple[int, int]], int, bool]:
    """NormalizeCigar (allelecounter.cc:777-846).

    read_seq / ref_bases: uint8 ASCII; interval_offset = read start
    relative to ref_bases[0]. Returns (cigar, read_shift, modified).
    """
    work = [[int(op), int(n)] for op, n in cigar]
    if not work:
        return cigar, 0, False
    modified = False
    read_shift = 0
    n_ref = len(ref_bases)
    n_read = len(read_seq)
    for _ in range(100000000):
        read_offset = 0
        cur_off = interval_offset + read_shift
        prev_len = work[0][1]
        shifted = False
        for i, (op, op_len) in enumerate(
            [(c[0], c[1]) for c in work]
        ):
            shift = 0
            if op in (_I, _D):
                while prev_len > 0:
                    if op == _D:
                        ok = (
                            read_offset > 0
                            and 0 <= cur_off + op_len - 1 < n_ref
                            and read_seq[read_offset - 1]
                            == ref_bases[cur_off + op_len - 1]
                        )
                    else:
                        ok = (
                            0 < cur_off <= n_ref
                            and read_offset + op_len - 1 < n_read
                            and read_seq[read_offset + op_len - 1]
                            == ref_bases[cur_off - 1]
                        )
                    if not ok:
                        break
                    cur_off -= 1
                    prev_len -= 1
                    read_offset -= 1
                    shift += 1
                if shift > 0:
                    # ShiftOperation (allelecounter.cc:647-685).
                    heading = i == 0 or (
                        i == 1 and work[0][0] == _S
                    )
                    if heading:
                        read_shift += _handle_heading_indel(work, i)
                    else:
                        prev = work[i - 1]
                        if _is_match(prev[0]):
                            prev[1] -= shift
                        else:
                            shift = 0
                    if shift > 0:
                        if i + 1 >= len(work):
                            work.append([_M, shift])
                        else:
                            nxt = work[i + 1]
                            if _is_match(nxt[0]):
                                nxt[1] += shift
                            else:
                                work.insert(i + 1, [_M, shift])
                        modified = True
                        shifted = True
                        break
            prev_len = op_len
            if _is_match(op):
                read_offset += op_len
                cur_off += op_len
            elif op in (_S, _I):
                read_offset += op_len
            elif op in (_D, _P, _N):
                cur_off += op_len
        merged = _swipe_and_merge(work)
        if merged:
            modified = True
        if not shifted and not merged:
            break
    head = 1 if work and work[0][0] == _S else 0
    read_shift += _handle_heading_indel(work, head)
    return [(c[0], c[1]) for c in work], read_shift, modified


def normalize_batch_cigars(
    batch, ref_bases: np.ndarray, interval_start: int
) -> int:
    """Left-align indels for every read in a batch (in place).

    Returns the number of reads whose alignment changed."""
    co = batch.cigar_offsets
    so = batch.seq_offsets
    has_indel = np.zeros(len(batch), bool)
    for i in range(len(batch)):
        ops = batch.cigar_ops[co[i] : co[i + 1]]
        has_indel[i] = bool(np.any((ops == _I) | (ops == _D)))
    if not has_indel.any():
        return 0
    new_cigars: List[Optional[List[Tuple[int, int]]]] = [None] * len(
        batch
    )
    n_changed = 0
    for i in np.nonzero(has_indel)[0]:
        ops = batch.cigar_ops[co[i] : co[i + 1]]
        lens = batch.cigar_lens[co[i] : co[i + 1]]
        seq = batch.seq[so[i] : so[i + 1]]
        cigar = list(zip(ops.tolist(), lens.tolist()))
        norm, shift, modified = normalize_cigar(
            seq, int(batch.pos[i]) - interval_start, cigar, ref_bases
        )
        if modified or shift:
            new_cigars[i] = norm
            batch.pos[i] = batch.pos[i] + shift
            n_changed += 1
    if n_changed == 0:
        return 0
    # Rebuild the flat cigar arrays.
    ops_parts, lens_parts = [], []
    new_off = np.zeros(len(batch) + 1, np.int64)
    for i in range(len(batch)):
        if new_cigars[i] is None:
            ops_parts.append(batch.cigar_ops[co[i] : co[i + 1]])
            lens_parts.append(batch.cigar_lens[co[i] : co[i + 1]])
        else:
            ops_parts.append(
                np.array([op for op, _ in new_cigars[i]], np.int8)
            )
            lens_parts.append(
                np.array([n for _, n in new_cigars[i]], np.int32)
            )
        new_off[i + 1] = new_off[i] + len(ops_parts[-1])
    batch.cigar_ops = np.concatenate(ops_parts) if ops_parts else \
        np.empty(0, np.int8)
    batch.cigar_lens = np.concatenate(lens_parts) if lens_parts else \
        np.empty(0, np.int32)
    batch.cigar_offsets = new_off
    return n_changed

"""Affine-gap local alignment (striped-Smith-Waterman semantics).

Replaces the reference's libssw wrapper (deepvariant/realigner/ssw.{h,cc},
WORKSPACE libssw). Same scoring convention: positive match score, positive
mismatch/gap penalties; alignment yields (score, ref_begin, cigar over
"=XIDS") with soft clips for unaligned query ends — the shape
FastPassAligner consumes.

The exact alignment REPORTED for a given optimal score is not unique;
the realigner goldens pin the choices the SSW library family makes, so
this module reproduces that three-phase procedure semantically:

1. Forward pass: full local DP. Endpoint = the lexicographically
   smallest (ref_end, query_end) among maximum-score cells (the striped
   scan keeps the first column where the running maximum strictly
   increases, then the smallest de-striped query index in that column).
2. Reverse pass: local DP over the reversed prefixes ending at the
   chosen endpoint, terminated at the first reversed-ref column that
   reaches the best score. Net effect: among co-optimal start points,
   the largest (ref_begin, query_begin) — the shortest span — wins.
3. Banded global alignment of the [begin..end] subsegments produces the
   cigar. Tie-breaks: diagonal beats gaps on equal score, a deletion
   (ref gap) beats an insertion on equal gap scores, and gap extension
   beats re-opening on equal scores. 'M' runs are split into '='/'X' by
   base comparison afterwards (the ssw_cpp post-pass behavior).

Phases 1-2 are numpy DPs; phase 3 is a small banded DP over the matched
subsegment. This is the port's copy of `deepvariant_tpu.realign.ssw`,
held to what that package computes with its native library loaded
(native/dvnative.cc): `align` is dv_ssw_align, `align(known_score=s)` is
dv_ssw_align_scored, whose forward pass stops at the first reference
row that holds a cell equal to `s`, and `local_scores` is the score-only
kernel dv_ssw_score_multi2, in which a no-call base never matches (in
`align` bytes are compared, so N matches N). Only reads that fail the
k-mer fast pass reach this code. Everything runs on the host, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

_NEG = np.int32(-(1 << 28))


@dataclasses.dataclass
class Alignment:
    sw_score: int = 0
    ref_begin: int = 0
    ref_end: int = 0       # exclusive on ref
    query_begin: int = 0
    query_end: int = 0     # exclusive on query
    cigar_string: str = ""


def _rle(ops: List[str]) -> str:
    out = []
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j] == ops[i]:
            j += 1
        out.append(f"{j - i}{ops[i]}")
        i = j
    return "".join(out)


_BASE_CODE = np.full(256, 4, np.int8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_CODE[_c] = _i


def local_scores(reference: str, queries: Sequence[str], match: int = 4,
                 mismatch: int = 6, gap_open: int = 8,
                 gap_extend: int = 2) -> np.ndarray:
    """Best local-alignment score of every query against `reference`,
    scores only (dv_ssw_score_multi2): the same affine-gap recurrence as
    `SswAligner._local_ends`, one DP row for all queries at a time, with
    one difference in the scoring: only A, C, G and T can match, so an N
    in the query never matches an N in the reference. Sequences are
    taken as given (callers pass upper case)."""
    out = np.zeros(len(queries), np.int64)
    if not queries or not reference:
        return out
    width = max(len(s) for s in queries)
    if width == 0:
        return out
    ref = _BASE_CODE[np.frombuffer(reference.encode(), np.uint8)].copy()
    ref[ref == 4] = 5  # a reference no-call equals no query code
    q = np.full((len(queries), width), 4, np.int8)  # padding never matches
    for r, s in enumerate(queries):
        q[r, :len(s)] = _BASE_CODE[np.frombuffer(s.encode(), np.uint8)]
    o, e = int(gap_open), int(gap_extend)
    n_q = len(queries)
    H = np.zeros((n_q, width + 1), np.int32)
    E = np.full((n_q, width + 1), _NEG, np.int32)
    h0 = np.zeros((n_q, width + 1), np.int32)
    col = np.arange(width, dtype=np.int32) * e
    best = np.zeros(n_q, np.int32)
    for code in ref:
        E = np.maximum(H - o, E - e)
        sub = np.where(q == code, match, -mismatch).astype(np.int32)
        np.maximum(H[:, :-1] + sub, E[:, 1:], out=h0[:, 1:])
        np.maximum(h0, 0, out=h0)  # column 0 stays 0
        run = np.maximum.accumulate(h0[:, :-1] + col, axis=1)
        H = h0.copy()
        np.maximum(h0[:, 1:], run - o - col, out=H[:, 1:])
        np.maximum(best, H.max(axis=1), out=best)
    return best.astype(np.int64)


class SswAligner:
    """match/mismatch/gap_open/gap_extend local aligner."""

    def __init__(self, match: int = 4, mismatch: int = 6,
                 gap_open: int = 8, gap_extend: int = 2):
        assert gap_open >= gap_extend >= 0, \
            "prefix-scan F recurrence requires gap_open >= gap_extend"
        self.match = int(match)
        self.mismatch = int(mismatch)
        self.gap_open = int(gap_open)
        self.gap_extend = int(gap_extend)
        self._ref: Optional[np.ndarray] = None

    def set_reference_sequence(self, reference: str):
        self._ref_bytes = reference.upper().encode()
        self._ref = np.frombuffer(self._ref_bytes, np.uint8)

    # -- numpy local DP ----------------------------------------------------

    def _local_ends(self, ref: np.ndarray, q: np.ndarray, target: int = 0):
        """Row by row over the local SW matrix (rows are ref positions,
        1-based): (score, ref_end, query_end) of the first maximum in
        row-major order, or, with `target` > 0, of the first row that
        holds a cell equal to `target` and the smallest query position in
        it, where the scan then stops (ssw_local_ends of the native
        library). Falls back to the maximum when no cell equals
        `target`."""
        m = len(q)
        o, e = self.gap_open, self.gap_extend
        col = np.arange(m, dtype=np.int32) * e
        o_col = col + o
        sub = {}
        prev = np.zeros(m + 1, np.int32)
        cur = np.zeros(m + 1, np.int32)
        h0 = np.zeros(m + 1, np.int32)       # column 0 stays 0
        E = np.full(m + 1, _NEG, np.int32)
        tmp = np.empty(m + 1, np.int32)
        run = np.empty(m, np.int32)
        best = best_i = best_j = 0
        for i, base in enumerate(ref.tolist(), 1):
            scores = sub.get(base)
            if scores is None:
                scores = sub[base] = np.where(
                    q == base, self.match, -self.mismatch).astype(np.int32)
            np.subtract(prev, o, out=tmp)
            np.subtract(E, e, out=E)
            np.maximum(E, tmp, out=E)
            np.add(prev[:-1], scores, out=h0[1:])
            np.maximum(h0[1:], E[1:], out=h0[1:])
            np.maximum(h0[1:], 0, out=h0[1:])
            # F[j] = max_{k<j} (h0[k] - o - (j-1-k)*e), via prefix max
            np.add(h0[:-1], col, out=run)
            np.maximum.accumulate(run, out=run)
            np.subtract(run, o_col, out=run)
            np.maximum(h0[1:], run, out=cur[1:])
            if target > 0:
                # The maximum is wanted only if no cell equals the
                # target, which a second scan then finds.
                hit = cur == target
                if hit.any():
                    return target, i, int(hit.argmax())
            else:
                row_best = int(cur.max())
                if row_best > best:
                    best, best_i, best_j = row_best, i, int(cur.argmax())
            prev, cur = cur, prev
        if target > 0:
            return self._local_ends(ref, q)
        return best, best_i, best_j

    def _banded_global(self, ref: np.ndarray, q: np.ndarray,
                       score: int) -> Optional[List[str]]:
        """Banded global DP over the matched subsegment, reproducing the
        band/rolling-buffer procedure of the SSW library's cigar stage
        (out-of-band neighbors read as 0, band doubling until the target
        score is reached). Returns per-base ops 'M'/'I'/'D' (query-major:
        'I' consumes query, 'D' consumes ref)."""
        ref_len, read_len = len(ref), len(q)
        go, ge = self.gap_open, self.gap_extend
        mt, mm = self.match, self.mismatch
        band_width = abs(ref_len - read_len) + 1
        while True:
            width = band_width * 2 + 3
            width_d = band_width * 2 + 1
            h_b = [0] * width
            e_b = [0] * width
            h_c = [0] * width
            # direction[(i * width_d + x) * 3 + p]; p: 0=E entry, 1=F
            # entry, 2=H entry. One flat array, as in dv_ssw_align: a
            # trace that steps out of the band then reads the
            # neighbouring row's cell, as it does there.
            row = width_d * 3
            direction = [0] * (row * read_len)
            max_score = 0
            u = 0
            for i in range(read_len):
                beg = max(0, i - band_width)
                end = min(ref_len - 1, i + band_width)
                edge = min(end + 1, width - 1)
                f = h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
                d0 = row * i
                off_i = max(0, i - band_width)
                off_p = max(0, i - 1 - band_width)
                for j in range(beg, end + 1):
                    u = j - off_i + 1
                    eu = j - off_p + 1
                    b = j - 1 - off_i + 1
                    d = j - 1 - off_p + 1
                    x3 = d0 + (j - off_i) * 3
                    if i == 0:
                        t1, t2 = -go, -ge
                    else:
                        t1 = h_b[eu] - go
                        t2 = e_b[eu] - ge
                    e_val = t1 if t1 > t2 else t2
                    e_dir = 3 if t1 > t2 else 2
                    e_b[u] = e_val
                    direction[x3] = e_dir

                    t1 = h_c[b] - go
                    t2 = f - ge
                    f = t1 if t1 > t2 else t2
                    f_dir = 5 if t1 > t2 else 4
                    direction[x3 + 1] = f_dir

                    e1 = e_val if e_val > 0 else 0
                    f1 = f if f > 0 else 0
                    t1 = e1 if e1 > f1 else f1
                    t2 = h_b[d] + (mt if ref[j] == q[i] else -mm)
                    h_c[u] = t1 if t1 > t2 else t2
                    if h_c[u] > max_score:
                        max_score = h_c[u]
                    if t1 <= t2:
                        direction[x3 + 2] = 1
                    else:
                        direction[x3 + 2] = e_dir if e1 > f1 else f_dir
                h_b[:u + 1] = h_c[:u + 1]
            if max_score >= score:
                break
            if band_width * 2 > ref_len + read_len:
                return None  # the band never reached the score
            band_width *= 2
        # Traceback from (read_len-1, ref_len-1) in H state.
        ops: List[str] = []
        i, j = read_len - 1, ref_len - 1
        p = 2  # 0=E, 1=F, 2=H
        while i > 0 or j > 0:
            at = row * i + (j - max(0, i - band_width)) * 3 + p
            if not 0 <= at < len(direction):
                return None
            dval = direction[at]
            if dval == 1:
                ops.append('M')
                i -= 1
                j -= 1
                p = 2
            elif dval == 2:
                ops.append('I')
                i -= 1
                p = 0
            elif dval == 3:
                ops.append('I')
                i -= 1
                p = 2
            elif dval == 4:
                ops.append('D')
                j -= 1
                p = 1
            elif dval == 5:
                ops.append('D')
                j -= 1
                p = 2
            else:
                return None  # the trace left the band
        ops.append('M')  # cell (0, 0): the first aligned pair
        ops.reverse()
        return ops

    def align(self, query: str, known_score: int = 0) -> Alignment:
        """Three-phase alignment of `query` to the reference sequence.

        `known_score` > 0 is a score from `local_scores`: the forward
        pass then ends at the first reference row that holds a cell
        equal to it (the smallest query position in that row) instead
        of at the first maximum. Where the two scorings agree that is
        the same endpoint; they part only on N-against-N pairs, which
        `local_scores` counts as mismatches. A `known_score` that no
        cell equals falls back to the plain maximum, and a reverse pass
        that cannot reach the forward score gives an empty Alignment.
        """
        assert self._ref is not None, "call set_reference_sequence first"
        q = np.frombuffer(query.upper().encode(), np.uint8)
        ref = self._ref
        n, m = len(ref), len(q)
        if n == 0 or m == 0:
            return Alignment()
        # Phase 1: forward endpoint (row-major: smallest ref row, then
        # query).
        best, re_i, re_j = self._local_ends(ref, q, max(int(known_score), 0))
        if best <= 0:
            return Alignment()
        # Phase 2: reverse-pass begins (shortest span among co-optimal).
        reached, ri, rj = self._local_ends(
            ref[:re_i][::-1], q[:re_j][::-1], best)
        if reached != best:
            return Alignment()
        ref_begin = re_i - ri      # 0-based inclusive start on ref
        query_begin = re_j - rj    # 0-based inclusive start on query
        # Phase 3: banded global cigar over the subsegment.
        ops = self._banded_global(
            ref[ref_begin:re_i], q[query_begin:re_j], best
        )
        if ops is None:
            return Alignment()
        # Split 'M' into '='/'X' by base comparison (ssw_cpp post-pass).
        out_ops: List[str] = []
        pi, pj = query_begin, ref_begin
        for op in ops:
            if op == 'M':
                out_ops.append("=" if ref[pj] == q[pi] else "X")
                pi += 1
                pj += 1
            elif op == 'I':
                out_ops.append('I')
                pi += 1
            else:
                out_ops.append('D')
                pj += 1
        cigar = []
        if query_begin > 0:
            cigar.append(f"{query_begin}S")
        if out_ops:
            cigar.append(_rle(out_ops))
        if m - re_j > 0:
            cigar.append(f"{m - re_j}S")
        return Alignment(
            sw_score=best,
            ref_begin=ref_begin,
            ref_end=re_i,
            query_begin=query_begin,
            query_end=re_j,
            cigar_string="".join(cigar),
        )

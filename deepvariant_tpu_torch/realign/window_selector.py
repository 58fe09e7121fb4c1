"""Assembly-window selection from allele-count evidence.

Behavior parity with reference window_selector.{py,cc}:
  * per-position candidate scores from the AlleleCounter over the region
    expanded by `region_expansion_in_bp` (window_selector.py:39-87);
  * VARIANT_READS model: each kept alt allele spreads its read count over
    positions by CIGAR type — SUB [i, i+1), INS/CLIP [i+1-(len-1), i+len),
    DEL [i+1, i+len) (window_selector.cc:105-146); positions with
    min<=count<=max become candidates;
  * ALLELE_COUNT_LINEAR model: weighted sum with learned coefficients,
    threshold at decision_boundary (window_selector.cc:149-208);
  * candidates merge into windows of radius min_windows_distance, merged
    when within 2*distance (window_selector.py:163-210).

The per-position accumulation is vectorized with np.add.at over
(start,end) difference arrays rather than the reference's per-position
loops. The port's copy of `deepvariant_tpu.realign.window_selector`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from deepvariant_tpu_torch.core.types import Range
from deepvariant_tpu_torch.io.bam import ReadBatch
from deepvariant_tpu_torch.make_examples.allele_counter import (
    AlleleCounter,
    AlleleCounterOptions,
    DELETION,
    INSERTION,
    REFERENCE,
    SOFT_CLIP,
    SUBSTITUTION,
)
from deepvariant_tpu_torch.realign.config import WindowSelectorOptions


def _allele_filter(allele, total_count: int,
                   config: WindowSelectorOptions) -> bool:
    """window_selector.cc:63-82 AlleleFilter."""
    if allele.type == REFERENCE:
        return False
    if allele.count < config.min_allele_support:
        return False
    if config.enable_strict_insertion_filter:
        if allele.type == INSERTION and len(allele.bases) <= 2:
            return total_count > 0 and \
                allele.count / total_count >= 0.08
    return True


def _range_update(acc: np.ndarray, start: int, end: int, by):
    start = max(start, 0)
    end = min(end, len(acc))
    if start < end:
        acc[start:end] += by


def variant_reads_counts(
    counter: AlleleCounter, config: WindowSelectorOptions
) -> np.ndarray:
    """Per-position supporting-read counts (window_selector.cc:105-146)."""
    width = len(counter.interval)
    counts = np.zeros(width, np.int64)
    for i in counter.positions_with_alleles():
        total = counter.total_allele_count(i)
        for allele in counter.sum_allele_counts(i):
            if not _allele_filter(allele, total, config):
                continue
            if allele.type == SUBSTITUTION:
                _range_update(counts, i, i + 1, allele.count)
            elif allele.type in (SOFT_CLIP, INSERTION):
                n = len(allele.bases)
                _range_update(counts, i + 1 - (n - 1), i + n, allele.count)
            elif allele.type == DELETION:
                n = len(allele.bases)
                _range_update(counts, i + 1, i + n, allele.count)
    return counts


def allele_count_linear_scores(
    counter: AlleleCounter, config: WindowSelectorOptions
) -> np.ndarray:
    """Per-position linear-model scores (window_selector.cc:149-208)."""
    model = config.allele_count_linear_model
    width = len(counter.interval)
    scores = np.full(width, model.bias, np.float64)
    # Reference-supporting reads contribute at their own position.
    scores += counter.ref_count * model.coeff_reference
    coeff = {
        SUBSTITUTION: model.coeff_substitution,
        SOFT_CLIP: model.coeff_soft_clip,
        INSERTION: model.coeff_insertion,
        DELETION: model.coeff_deletion,
    }
    for i in counter.positions_with_alleles():
        pc = counter.position_count(i)
        # The C++ kernel iterates raw read alleles (incl. low-quality).
        for rec in pc.read_alleles.values():
            c = coeff.get(rec.type)
            if c is None:
                continue
            if rec.type == SUBSTITUTION:
                _range_update(scores, i, i + 1, c)
            elif rec.type in (SOFT_CLIP, INSERTION):
                n = len(rec.bases)
                _range_update(scores, i + 1 - (n - 1), i + n, c)
            elif rec.type == DELETION:
                n = len(rec.bases)
                _range_update(scores, i + 1, i + n, c)
    return scores


def _variant_reads_counts_vectorized(
    batch: ReadBatch,
    read_indices: np.ndarray,
    ref: np.ndarray,
    interval: Range,
    prev_base: str,
    config: WindowSelectorOptions,
) -> Optional[np.ndarray]:
    """variant_reads_counts computed straight off the shared cigar-unit
    table — no PositionCount / ReadAlleleRecord materialization. Same
    event semantics as AlleleCounter (anchored indels, consecutive-
    event dedup, HQ-only sums) followed by the per-allele spreading of
    window_selector.cc:105-146. Returns None when a case needs the
    counter-based fallback (strict insertion filter wants per-position
    total depth)."""
    from deepvariant_tpu_torch.make_examples.allele_counter import (
        _IS_CANONICAL,
        _MATCH_OPS,
        _OP_D,
        _OP_I,
        _OP_S,
        build_unit_table,
    )

    if config.enable_strict_insertion_filter:
        return None
    width = len(interval)
    counts = np.zeros(width, np.int64)
    units = build_unit_table(batch, read_indices, interval.start)
    if units is None:
        return counts
    min_q = config.min_base_quality
    legacy = config.keep_legacy_behavior

    # --- substitution events (vectorized per-base expansion) -------------
    ops = units["ops"]
    m = _MATCH_OPS[ops]
    u_read = units["read"][m]
    u_len = units["lens"][m]
    u_ref = units["ref_starts"][m]
    u_rd = units["read_starts"][m]
    sub_read = sub_pos = sub_base = np.empty(0, np.int64)
    total = int(u_len.sum())
    if total:
        rep = u_len
        base_read = np.repeat(u_read, rep)
        cum = np.concatenate([[0], np.cumsum(rep)[:-1]])
        intra = np.arange(total, dtype=np.int64) - np.repeat(cum, rep)
        base_pos = np.repeat(u_ref, rep) + intra
        base_readoff = np.repeat(u_rd, rep) + intra
        seq_global = batch.seq_offsets[base_read] + base_readoff
        bases = batch.seq[seq_global]
        quals = batch.qual[seq_global]
        ok = (
            (base_pos >= 0) & (base_pos < width)
            & _IS_CANONICAL[bases]
        )
        base_read, base_pos = base_read[ok], base_pos[ok]
        bases, quals = bases[ok], quals[ok]
        # HQ substitutions only (low-quality subs never reach
        # sum_allele_counts; legacy mode drops them earlier with the
        # same observable effect here).
        is_sub = (bases != ref[base_pos]) & (quals >= min_q)
        sub_read = base_read[is_sub]
        sub_pos = base_pos[is_sub]
        sub_base = bases[is_sub].astype(np.int64)

    # --- indel events (rare; scalar walk over indel units) ---------------
    indel_mask = (ops == _OP_I) | (ops == _OP_D) | (ops == _OP_S)
    # (read, anchor_pos) -> (intra, bases, type, low_q); "last indel at
    # an anchor wins" like _apply_events.
    last_indel: dict = {}
    if indel_mask.any():
        idx = np.nonzero(indel_mask)[0]
        r_l = units["read"][idx].tolist()
        op_l = ops[idx].tolist()
        len_l = units["lens"][idx].tolist()
        refoff_l = units["ref_starts"][idx].tolist()
        readoff_l = units["read_starts"][idx].tolist()
        k_l = units["intra"][idx].tolist()
        so_l = batch.seq_offsets[units["read"][idx]].tolist()
        seq_all, qual_all = batch.seq, batch.qual
        for r, op, op_len, ioff, roff, k, sbase in zip(
                r_l, op_l, len_l, refoff_l, readoff_l, k_l, so_l):
            anchor = ioff - 1
            if roff == 0:
                if ioff == 0:
                    prev = prev_base
                elif 0 < ioff <= width:
                    prev = chr(ref[ioff - 1])
                else:
                    prev = "N"
            else:
                prev = chr(seq_all[sbase + roff - 1])
            if prev not in "ACGT":
                continue
            low_q = False
            if op == _OP_D:
                atype = DELETION
                # The selector's counter has no reference tail:
                # deletions running past the window drop, matching
                # AlleleCounter(ref_bases_after=empty).
                if ioff < 0 or ioff + op_len > width:
                    continue
                dref = ref[ioff:ioff + op_len]
                if not _IS_CANONICAL[dref].all():
                    continue
                bases_s = prev + dref.tobytes().decode()
            else:
                atype = INSERTION if op == _OP_I else SOFT_CLIP
                ins = seq_all[sbase + roff: sbase + roff + op_len]
                insq = qual_all[sbase + roff: sbase + roff + op_len]
                if not _IS_CANONICAL[ins].all():
                    continue
                qsum = int(insq.sum())
                if legacy:
                    if (insq < min_q).any():
                        continue
                elif qsum < min_q * op_len:
                    low_q = True
                bases_s = prev + ins.tobytes().decode()
            key = (r, anchor)
            prev_entry = last_indel.get(key)
            if prev_entry is None or k > prev_entry[0]:
                last_indel[key] = (k, bases_s, atype, low_q)

    # --- consecutive-event dedup: drop subs superseded by indels ---------
    if last_indel and len(sub_read):
        stride = width + 2
        keys = np.fromiter(
            (r * stride + p + 1 for r, p in last_indel),
            np.int64, len(last_indel),
        )
        ev_key = sub_read * stride + sub_pos + 1
        keep2 = ~np.isin(ev_key, keys)
        sub_pos, sub_base = sub_pos[keep2], sub_base[keep2]

    # --- aggregate + spread (window_selector.cc:105-146) ------------------
    min_support = config.min_allele_support
    if len(sub_pos):
        packed = sub_pos * 256 + sub_base
        uniq, cnt = np.unique(packed, return_counts=True)
        okg = cnt >= min_support
        np.add.at(counts, (uniq[okg] // 256), cnt[okg])

    indel_agg: dict = {}
    for (r, pos), (_, bases_s, atype, low_q) in last_indel.items():
        if low_q or not 0 <= pos < width:
            continue
        indel_agg[(pos, bases_s, atype)] = indel_agg.get(
            (pos, bases_s, atype), 0
        ) + 1
    diff = np.zeros(width + 1, np.int64)
    for (pos, bases_s, atype), cnt in indel_agg.items():
        if cnt < min_support:
            continue
        n = len(bases_s)
        if atype == DELETION:
            lo, hi = pos + 1, pos + n
        else:
            lo, hi = pos + 1 - (n - 1), pos + n
        lo, hi = max(lo, 0), min(hi, width)
        if lo < hi:
            diff[lo] += cnt
            diff[hi] -= cnt
    counts += np.cumsum(diff[:-1])
    return counts


def candidates_from_reads(
    config: WindowSelectorOptions,
    ref_query,
    batch: ReadBatch,
    region: Range,
    contig_length: Optional[int] = None,
) -> List[int]:
    """Candidate realignment positions in `region` (expanded)."""
    start = max(0, region.start - config.region_expansion_in_bp)
    end = region.end + config.region_expansion_in_bp
    if contig_length is not None:
        end = min(end, contig_length)
    expanded = Range(region.reference_name, start, end)
    ref_bases = ref_query(expanded)
    if isinstance(ref_bases, str):
        ref_bases = np.frombuffer(ref_bases.encode(), np.uint8)
    prev = "N"
    if start > 0:
        prev_arr = ref_query(Range(region.reference_name, start - 1, start))
        prev = prev_arr if isinstance(prev_arr, str) else \
            bytes(prev_arr).decode()
    keep_idx = np.nonzero(batch.mapq >= config.min_mapq)[0]

    if config.model_type == "variant_reads":
        model = config.variant_reads_model
        counts = _variant_reads_counts_vectorized(
            batch, keep_idx, ref_bases, expanded, prev, config
        )
        if counts is None:
            counter = AlleleCounter(
                ref_bases, expanded,
                AlleleCounterOptions(
                    min_base_quality=config.min_base_quality,
                    min_mapping_quality=config.min_mapq,
                    keep_legacy_behavior=config.keep_legacy_behavior,
                ),
                ref_prev_base=prev,
            )
            counter.add_batch(batch.subset(keep_idx))
            counts = variant_reads_counts(counter, config)
        lo = model.min_num_supporting_reads
        hi = model.max_num_supporting_reads
        hits = np.nonzero((counts >= lo) & (counts <= hi))[0]
        return [expanded.start + int(i) for i in hits]

    counter = AlleleCounter(
        ref_bases,
        expanded,
        AlleleCounterOptions(
            min_base_quality=config.min_base_quality,
            min_mapping_quality=config.min_mapq,
            keep_legacy_behavior=config.keep_legacy_behavior,
        ),
        ref_prev_base=prev,
    )
    counter.add_batch(batch.subset(keep_idx))

    if config.model_type == "allele_count_linear":
        model = config.allele_count_linear_model
        scores = allele_count_linear_scores(counter, config)
        return [
            expanded.start + i
            for i, s in enumerate(scores)
            if s > model.decision_boundary
        ]
    raise ValueError(f"unknown window selector model {config.model_type}")


def candidates_to_windows(
    config: WindowSelectorOptions,
    candidate_pos: Sequence[int],
    ref_name: str,
) -> List[Range]:
    """Merge candidate positions into assembly windows
    (window_selector.py:163-210)."""
    windows: List[Range] = []

    def add_window(start_pos: int, end_pos: int):
        windows.append(Range(
            ref_name,
            start_pos - config.min_windows_distance,
            end_pos + config.min_windows_distance,
        ))

    start_pos, end_pos = None, None
    for pos in sorted(candidate_pos):
        if start_pos is None:
            start_pos, end_pos = pos, pos
        elif pos > end_pos + 2 * config.min_windows_distance:
            add_window(start_pos, end_pos)
            start_pos, end_pos = pos, pos
        else:
            end_pos = pos
    if start_pos is not None:
        add_window(start_pos, end_pos)
    return sorted(windows, key=lambda r: (r.reference_name, r.start, r.end))


def select_windows(
    config: WindowSelectorOptions,
    ref_query,
    batch: ReadBatch,
    region: Range,
    contig_length: Optional[int] = None,
) -> List[Range]:
    """Candidate windows for local assembly (window_selector.py:212)."""
    if config.realign_all:
        return candidates_to_windows(
            config, list(range(region.start, region.end)),
            region.reference_name,
        )
    candidates = candidates_from_reads(
        config, ref_query, batch, region, contig_length
    )
    return candidates_to_windows(config, candidates, region.reference_name)

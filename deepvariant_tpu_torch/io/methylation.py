"""MM/ML base-modification decoding (5mC and 6mA).

The port's copy of `deepvariant_tpu.io.methylation`, Python on the host
as there. Nucleus parity: sam_reader.cc's MM/ML aux parsing into
Read.base_modifications — per-read-base modification probabilities
(0-255) that feed the base_methylation pileup channel (enum 23).

Handles the standard SAM tags:
  MM:Z:C+m,<d0>,<d1>,...;   deltas = skipped C count between mods
  ML:B:C,<p0>,<p1>,...      probability byte per modified base
For reverse-strand alignments the tag refers to the original
(pre-alignment) sequence, so positions walk the complement from the
3' end of the aligned sequence.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_MM_ITEM = re.compile(
    r"([ACGTUN])([-+])([a-z]+|\d+)([.?]?)((?:,\d+)*);"
)
_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def decode_base_modifications(
    aligned_sequence: str,
    mm: str,
    ml: Optional[np.ndarray],
    is_reverse: bool,
) -> Dict[str, np.ndarray]:
    """{mod_code (e.g. 'C+m'): uint8[len(read)] probabilities}.

    Probabilities align to `aligned_sequence` coordinates.
    """
    out: Dict[str, np.ndarray] = {}
    if not mm:
        return out
    ml_offset = 0
    seq = aligned_sequence.upper()
    n = len(seq)
    for match in _MM_ITEM.finditer(mm if mm.endswith(";") else mm + ";"):
        base, strand, mods, _flag, deltas_text = match.groups()
        deltas = [int(x) for x in deltas_text.split(",")[1:]] \
            if deltas_text else []
        # One ML probability per (delta, mod-code char).
        mod_codes = [mods] if mods.isdigit() else list(mods)
        # Positions of `base` in the original read orientation.
        if is_reverse:
            search_base = _COMPLEMENT.get(base, base)
            base_positions = [
                n - 1 - i for i, c in enumerate(reversed(seq))
                if c == search_base
            ]
            # reversed walk: index i counts from the 3' end.
            base_positions = [
                i for i in range(n - 1, -1, -1)
                if seq[i] == search_base
            ]
        else:
            base_positions = [i for i in range(n) if seq[i] == base]
        values = np.zeros(n, np.uint8)
        bi = 0
        for di, delta in enumerate(deltas):
            bi += delta
            if bi >= len(base_positions):
                break
            pos = base_positions[bi]
            if ml is not None:
                ml_index = ml_offset + di * len(mod_codes)
                prob = int(ml[ml_index]) if ml_index < len(ml) else 0
            else:
                prob = 255
            values[pos] = prob
            bi += 1
        ml_offset += len(deltas) * len(mod_codes)
        for code in mod_codes:
            key = f"{base}{strand}{code}"
            if key in out:
                out[key] = np.maximum(out[key], values)
            else:
                out[key] = values
    return out


def base_modification_values(
    aligned_sequence: str,
    aux: Dict[str, object],
    is_reverse: bool,
    mod_code: str,
) -> Optional[np.ndarray]:
    """Probabilities per aligned base for one modification code.

    mod_code: 'm' = 5mC, 'a' = 6mA (nucleus sam_reader.h:57-58
    k5mC/k6mA registry).
    """
    mm = aux.get("MM") or aux.get("Mm")
    if not isinstance(mm, str):
        return None
    ml = aux.get("ML")
    if ml is None:
        ml = aux.get("Ml")
    mods = decode_base_modifications(
        aligned_sequence, mm, ml, is_reverse
    )
    for key, values in mods.items():
        if key.endswith(mod_code):
            return values
    return None


def methylation_values(
    aligned_sequence: str,
    aux: Dict[str, object],
    is_reverse: bool,
) -> Optional[np.ndarray]:
    """5mC probabilities per aligned base from a read's aux tags."""
    return base_modification_values(
        aligned_sequence, aux, is_reverse, "m"
    )

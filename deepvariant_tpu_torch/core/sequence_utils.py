"""DNA sequence utilities (nucleus util/sequence_utils.py behavior).

The port's copy of `deepvariant_tpu.core.sequence_utils`: the
complement-dictionary families by alphabet strictness, plus a
reverse_complement that rejects bases outside the chosen alphabet.
The hot path (GBZ haplotype extraction, io/gbz.py) uses the
translation-table fast path; the dict-driven form exists for
IUPAC/lowercase alphabets.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional


class Error(Exception):
    """Raised for sequences containing bases outside the alphabet."""


def _add_lowercase(d: Dict[str, str]) -> Dict[str, str]:
    out = dict(d)
    out.update({k.lower(): v.lower() for k, v in d.items()})
    return out


STRICT_DNA_COMPLEMENT_UPPER = {"A": "T", "T": "A", "C": "G", "G": "C"}
DNA_COMPLEMENT_UPPER = {**STRICT_DNA_COMPLEMENT_UPPER, "N": "N"}
IUPAC_DNA_COMPLEMENT_UPPER = {
    **DNA_COMPLEMENT_UPPER,
    # IUPAC ambiguity codes complement to the codes for their
    # complemented base sets.
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D",
}

STRICT_DNA_COMPLEMENT = _add_lowercase(STRICT_DNA_COMPLEMENT_UPPER)
DNA_COMPLEMENT = _add_lowercase(DNA_COMPLEMENT_UPPER)
IUPAC_DNA_COMPLEMENT = _add_lowercase(IUPAC_DNA_COMPLEMENT_UPPER)

STRICT_DNA_BASES_UPPER: FrozenSet[str] = frozenset(
    STRICT_DNA_COMPLEMENT_UPPER
)
STRICT_DNA_BASES: FrozenSet[str] = frozenset(STRICT_DNA_COMPLEMENT)
DNA_BASES_UPPER: FrozenSet[str] = frozenset(DNA_COMPLEMENT_UPPER)
DNA_BASES: FrozenSet[str] = frozenset(DNA_COMPLEMENT)

_STRICT_UPPER_TABLE = bytes.maketrans(b"ACGT", b"TGCA")


def reverse_complement(
    seq: str, complement_dict: Optional[Dict[str, str]] = None
) -> str:
    """Reverse complement of `seq` under the given alphabet
    (sequence_utils.py:94-124; defaults to strict uppercase ACGT).
    Raises Error on any base the alphabet does not cover."""
    if complement_dict is None:
        complement_dict = STRICT_DNA_COMPLEMENT_UPPER
    try:
        return "".join(complement_dict[b] for b in reversed(seq))
    except KeyError:
        raise Error(f"Unknown base in {seq}")

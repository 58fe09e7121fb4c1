"""CIGAR utilities, both object-level and vectorized (numpy) forms.

The vectorized forms operate on parallel (ops, lens) int32 arrays as produced
by the columnar ReadBatch (nucleus util/cigar.py behavior). A copy of
`deepvariant_tpu.core.cigar`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import (
    CHAR_TO_PROTO_OP,
    OPS_CONSUME_READ,
    OPS_CONSUME_REF,
    PROTO_OP_TO_CHAR,
)

# Boolean lookup tables indexed by proto op code (0..9).
_CONSUMES_READ = np.zeros(10, dtype=bool)
for _op in OPS_CONSUME_READ:
    _CONSUMES_READ[_op] = True
_CONSUMES_REF = np.zeros(10, dtype=bool)
for _op in OPS_CONSUME_REF:
    _CONSUMES_REF[_op] = True


def parse_cigar_string(text: str) -> List[Tuple[int, int]]:
    """'10M2I5D' -> [(op, length), ...] with proto op codes.

    Rejects malformed strings the way nucleus util/cigar.py
    parse_cigar_string does: empty input, an op with no leading
    length, trailing digits, zero/negative lengths, unknown op
    characters, and lengths beyond int64."""
    units = []
    num = 0
    have_digits = False
    for ch in text:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            have_digits = True
        else:
            op = CHAR_TO_PROTO_OP.get(ch)
            if op is None:
                raise ValueError(f"invalid cigar operation {ch!r} in {text!r}")
            if not have_digits or num <= 0:
                raise ValueError(f"cigar unit needs a positive length: {text!r}")
            if num > 0x7FFFFFFFFFFFFFFF:
                raise ValueError(f"cigar length overflows int64: {text!r}")
            units.append((op, num))
            num = 0
            have_digits = False
    if have_digits or not units:
        raise ValueError(f"malformed cigar string: {text!r}")
    return units


def format_cigar(units: List[Tuple[int, int]]) -> str:
    return "".join(f"{l}{PROTO_OP_TO_CHAR[op]}" for op, l in units)


def ref_span(units: List[Tuple[int, int]]) -> int:
    return sum(l for op, l in units if op in OPS_CONSUME_REF)


def read_span(units: List[Tuple[int, int]]) -> int:
    return sum(l for op, l in units if op in OPS_CONSUME_READ)


def ref_span_array(ops: np.ndarray, lens: np.ndarray) -> int:
    return int(np.sum(lens[_CONSUMES_REF[ops]]))


def read_span_array(ops: np.ndarray, lens: np.ndarray) -> int:
    return int(np.sum(lens[_CONSUMES_READ[ops]]))

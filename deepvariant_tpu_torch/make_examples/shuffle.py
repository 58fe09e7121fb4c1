"""The crowded-window read shuffle: libc++'s std::shuffle over
std::mt19937_64, in numpy and Python integers.

When more reads overlap a candidate than the pileup has rows, the read
index list is shuffled with `std::shuffle(..., std::mt19937_64(seed))`
and cut (DownsampleReadIndices, pileup_image_native.cc:153-165).
std::shuffle's index distribution is implementation-defined; the
reference's release builds pin libc++'s: a forward Fisher-Yates where
each bounded draw masks the engine's output to ceil(log2(range)) bits
and rejects values >= range. The JAX package computes it in its native
library (`dv_shuffle_indices`); this is the same algorithm with no
compiled code.
"""

from __future__ import annotations

import numpy as np

_N, _M = 312, 156
_MASK64 = (1 << 64) - 1
_UPPER, _LOWER = 0xFFFFFFFF80000000, 0x7FFFFFFF
_MATRIX_A = 0xB5026F5AA96619E9


class Mt19937_64:
    """std::mt19937_64: the 64-bit Mersenne Twister of Matsumoto and
    Nishimura, seeded as the C++ standard prescribes."""

    def __init__(self, seed: int):
        state = [0] * _N
        state[0] = seed & _MASK64
        for i in range(1, _N):
            prev = state[i - 1]
            state[i] = (6364136223846793005 * (prev ^ (prev >> 62)) + i) \
                & _MASK64
        self._state = state
        self._next = _N

    def _twist(self):
        s = self._state
        for i in range(_N):
            x = (s[i] & _UPPER) | (s[(i + 1) % _N] & _LOWER)
            s[i] = s[(i + _M) % _N] ^ (x >> 1) ^ (_MATRIX_A if x & 1 else 0)
        self._next = 0

    def __call__(self) -> int:
        if self._next >= _N:
            self._twist()
        x = self._state[self._next]
        self._next += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x & _MASK64


def _bounded_draw(engine: Mt19937_64, span: int) -> int:
    """A draw in [0, span): libc++'s uniform_int_distribution over a
    64-bit engine."""
    if span == 1:
        return 0
    mask = (1 << (span - 1).bit_length()) - 1
    while True:
        u = engine() & mask
        if u < span:
            return u


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """std::shuffle(iota(n), mt19937_64(seed)) as libc++ draws it: the
    permutation of 0..n-1, int32."""
    order = list(range(n))
    engine = Mt19937_64(seed)
    for first in range(n - 1):
        i = _bounded_draw(engine, n - first)
        if i:
            order[first], order[first + i] = order[first + i], order[first]
    return np.array(order, np.int32)

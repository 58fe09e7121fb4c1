"""Finite probability distributions as a functor/monad.

The port's copy of `deepvariant_tpu.core.distribution`: pure Python over
exact integer weights, so every `Distribution` equals the JAX package's.

Port of the reference's distribution_functor library
(deepvariant/distribution_functor.h): a `Distribution` is an exact
rational weight map over a finite set of outcomes, closed under
`dist_map` (functor map), `dist_bind` (monadic bind) and tracing a
function that consumes randomness through a `DistributionGenerator`
(deepvariant/distribution_functor.h:120-209 DistributionTracer).

All arithmetic is exact: weights are integers, normalized so their
GCD (including the total) is 1, matching the reference's
`Distribution::normalize` (distribution_functor.h:89-97). Tracing
enumerates every execution path of the traced function by replaying
recorded provider responses — equivalent to the reference's explicit
explore-stack machine, expressed recursively.
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd, lcm
from typing import Callable, Dict, Generic, Hashable, TypeVar

T = TypeVar("T", bound=Hashable)
R = TypeVar("R", bound=Hashable)


class Distribution(Generic[T]):
    """An exact distribution over finitely many outcomes.

    Weights are positive integers whose collective GCD (with the
    total) is 1; equal weight maps compare equal regardless of how
    they were built.
    """

    __slots__ = ("_weight_map", "_total_weight")

    def __init__(self, weight_map: Dict[T, int], total_weight: int):
        self._weight_map = weight_map
        self._total_weight = total_weight

    @classmethod
    def from_weight_map(cls, weight_map: Dict[T, int]) -> "Distribution[T]":
        kept = {t: int(w) for t, w in weight_map.items() if w > 0}
        total = sum(kept.values())
        factor = total
        for w in kept.values():
            factor = gcd(factor, w)
        if factor > 1:
            kept = {t: w // factor for t, w in kept.items()}
            total //= factor
        return cls(kept, total)

    @property
    def weight_map(self) -> Dict[T, int]:
        return dict(self._weight_map)

    @property
    def total_weight(self) -> int:
        return self._total_weight

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Distribution):
            return NotImplemented
        return self._weight_map == other._weight_map

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return (
            f"Distribution({self._weight_map!r}, "
            f"total={self._total_weight})"
        )


def unit(value: T) -> Distribution[T]:
    """The point-mass distribution (monadic return)."""
    return Distribution.from_weight_map({value: 1})


def uniform(values) -> Distribution[T]:
    """Uniform over the given values."""
    return Distribution.from_weight_map({v: 1 for v in values})


def _from_fractions(probs: Dict[R, Fraction]) -> Distribution[R]:
    denom = 1
    for p in probs.values():
        denom = lcm(denom, p.denominator)
    return Distribution.from_weight_map(
        {r: int(p * denom) for r, p in probs.items()}
    )


class DistributionGenerator(Generic[T]):
    """A parameterized family of distributions: args -> Distribution.

    Maps a (potentially infinite) product of distributions; a traced
    function can only consume finitely much randomness, so
    `dist_map(generator, f)` is still a finite Distribution.
    """

    __slots__ = ("_g",)

    def __init__(self, g: Callable[..., Distribution[T]]):
        self._g = g

    def __call__(self, *args) -> Distribution[T]:
        return self._g(*args)


def dist_map(dist, fn) -> Distribution:
    """Functor map. On a `Distribution`, applies `fn` to every
    outcome (merging collisions). On a `DistributionGenerator`,
    `fn` receives a provider callable and the result enumerates every
    execution path, weighting each by the product of its draws'
    probabilities (distribution_functor.h Trace())."""
    if isinstance(dist, DistributionGenerator):
        return _trace(dist, fn)
    probs: Dict[Hashable, Fraction] = {}
    for t, w in dist._weight_map.items():
        r = fn(t)
        probs[r] = probs.get(r, Fraction(0)) + Fraction(
            w, dist._total_weight
        )
    return _from_fractions(probs)


def dist_bind(dist: Distribution[T], fn) -> Distribution:
    """Monadic bind: `fn` maps each outcome to a Distribution; the
    result mixes them by the outer weights, exactly."""
    probs: Dict[Hashable, Fraction] = {}
    for t, w in dist._weight_map.items():
        outer = Fraction(w, dist._total_weight)
        inner = fn(t)
        for r, iw in inner._weight_map.items():
            probs[r] = probs.get(r, Fraction(0)) + outer * Fraction(
                iw, inner._total_weight
            )
    return _from_fractions(probs)


def _trace(gen: DistributionGenerator, fn) -> Distribution:
    """Enumerate all execution paths of `fn(provider)`.

    Each provider call at path position i draws from
    `gen(*args_at_i)`; a path's probability is the product of its
    draws. Replays `fn` once per path (the call sequence may depend
    on earlier responses, so paths cannot be precomputed)."""
    probs: Dict[Hashable, Fraction] = {}

    class _Branch(Exception):
        def __init__(self, args):
            self.args_tuple = args

    def run(prefix):
        # prefix: chosen (value, prob) per provider call so far.
        calls = 0

        def provider(*args):
            nonlocal calls
            i = calls
            calls += 1
            if i < len(prefix):
                return prefix[i][0]
            raise _Branch(args)

        try:
            result = fn(provider)
        except _Branch as b:
            dist = gen(*b.args_tuple)
            for v, w in dist._weight_map.items():
                run(prefix + [(v, Fraction(w, dist._total_weight))])
            return
        p = Fraction(1)
        for _, pr in prefix:
            p *= pr
        probs[result] = probs.get(result, Fraction(0)) + p

    run([])
    return _from_fractions(probs)

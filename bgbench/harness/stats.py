"""Order statistics and interval arithmetic the readers share."""
from __future__ import annotations

import math
import random
from typing import Iterable, List, Sequence, Tuple

__all__ = ["percentile", "union_length", "gaps", "Reservoir"]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of every value:
    the smallest value with at least ``q`` % of all values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[k - 1]


def _merged(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    return sum(b - a for a, b in _merged(intervals, lo, hi))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers, in order."""
    out, at = [], lo
    for a, b in _merged(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = b
    if hi > at:
        out.append((at, hi))
    return out


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (Algorithm R). ``offer(i)`` says whether item ``i`` (0, 1,
    ...) enters, and which slot it takes."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []

    def offer(self, i: int):
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item

"""Statistics the metrics share: a percentile over every task, and the union
of device intervals and the gaps it leaves."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile of all ``values``: the smallest
    value with at least ``p`` percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(ordered)))
    return ordered[rank - 1]


def union(intervals: Iterable[Tuple[float, float]],
          lo: float = -math.inf, hi: float = math.inf) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of ``intervals`` clipped to ``[lo, hi]``."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals)
    out: List[Tuple[float, float]] = []
    for a, b in clipped:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The gaps inside ``[lo, hi]`` that a merged union leaves."""
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out

"""The arithmetic of the end-to-end metrics: tails and counts in the window."""

from __future__ import annotations

import math

MISSING = math.inf  # a request that never answered sorts after every time


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least q% of the values at or below it.
    ``MISSING`` entries sort last, so a tail that reaches them is
    ``MISSING``. Raises on an empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    if not 0 < q <= 100:
        raise ValueError(f"percentile must be in (0, 100], got {q}")
    rank = math.ceil(q / 100 * len(xs))
    return xs[max(rank, 1) - 1]


def gaps_in_window(times, t0: float, t1: float) -> list[float]:
    """Gaps between consecutive ``times`` (one request's token arrivals)
    where both tokens fall in [t0, t1)."""
    inside = [t for t in times if t0 <= t < t1]
    return [b - a for a, b in zip(inside, inside[1:])]


def count_in_window(times, t0: float, t1: float) -> int:
    return sum(1 for t in times if t0 <= t < t1)


"""The benchmark's arithmetic on spans: percentiles, rates, spreads and
the union of busy intervals. Plain Python, no numpy, so that the rule is
visible: a later change to a library's defaults cannot move it."""
from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float | None:
    """Nearest-rank percentile: the smallest value with at least ``p``% of
    the values at or below it. None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    if not 0 < p <= 100:
        raise ValueError(f"percentile {p} outside (0, 100]")
    k = max(1, math.ceil(p / 100.0 * len(xs)))
    return float(xs[k - 1])


def mean(values) -> float | None:
    xs = list(values)
    return float(sum(xs) / len(xs)) if xs else None


def rate(count: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return float(count) / float(seconds)


def spread(values) -> float:
    """Distance between the first and third quartile, as a share of the
    median (``statistics.quantiles(values, n=4)``, the rule the bounds
    are set by)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / abs(q2)


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals, overlaps
    counted once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if b <= cur:
            continue
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]

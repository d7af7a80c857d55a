"""The arithmetic of the end-to-end and per-layer numbers."""
from __future__ import annotations

import math


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile over every sample (q in 0..100): the
    smallest sample with at least q % of the samples at or below it."""
    ordered = sorted(samples)
    if not ordered:
        raise ValueError("percentile of no samples")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count: int, seconds: float) -> float:
    """All the work over all the time of the window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds


def union_seconds(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total

"""The arithmetic of the metrics and of the bounds: percentiles, the
closed loop's window, and the spread that a bound is set from."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    order statistics (numpy's default): the value below which ``q``% of
    the samples lie."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def closed_window(start: float, ends: Sequence[float], seconds: float):
    """A closed loop's window: from ``start`` to the end of the first call
    that completes at or after ``start + seconds``.  ``ends``: the calls'
    completion times in order.  -> (calls inside, window length), or
    None if no call completes after the mark."""
    for i, end in enumerate(ends):
        if end - start >= seconds:
            return i + 1, end - start
    return None


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile, as Python's
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def bound(spreads: Sequence[float], factor: float = 5.0,
          floor: float = 0.01, cap: float = 0.25) -> float:
    """About ``factor`` times the widest spread, never under ``floor``
    nor over ``cap``."""
    return min(cap, max(floor, factor * max(spreads)))

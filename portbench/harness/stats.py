"""Window statistics: percentiles over every sample, rates over the
window.  No statistic is a median of chunks or of ticks."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0 <= q <= 100) of ``values`` with linear
    interpolation between the order statistics at rank q/100 * (n - 1)
    (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    rank = q / 100.0 * (len(xs) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


"""The arithmetic of the end-to-end and host-clock metrics, over every
request and every gap: percentiles, rates, inter-token gaps."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0..100) by linear interpolation between closest
    ranks (numpy's default).  A missing sample is +inf and ranks above
    every finite one; None for no samples."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def gaps_in(stamps: Sequence[float], t0: float, t1: float) -> List[float]:
    """The gaps between consecutive token stamps of one request whose later
    token falls in the window (t0, t1]."""
    return [b - a for a, b in zip(stamps, stamps[1:]) if t0 < b <= t1]


def tokens_in(stamps: Iterable[float], t0: float, t1: float) -> int:
    return sum(1 for t in stamps if t0 < t <= t1)

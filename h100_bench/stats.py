"""Percentiles, as the benchmark defines them."""

from __future__ import annotations

import math

__all__ = ["percentile"]


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


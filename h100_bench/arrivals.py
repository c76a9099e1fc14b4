"""The open loop's arrival schedule, read from a traffic file's numbers.

Poisson arrivals at ``rate`` requests/s, raised to ``rate * burst_factor``
for the last ``burst_s`` seconds of every ``period_s`` (no bursts when
``period_s`` is None): the shape of a seeded bursty trace (exponential
gaps, a burst at 3x the rate). So that the seed changes the order of the
work and not its amount, each phase holds ``round(rate * length)``
arrivals whose gaps are the exponential distribution's quantiles at
(j + 0.5) / n, stretched to fill the phase, in one fixed shuffled order
that the seed rotates: every seed offers the same gaps, clustered alike,
starting at another point of the sequence.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["schedule"]


_ORDER_SEED = 1710061890  # the fixed order of the gaps (the paper's arXiv id)


def _phase(start: float, length: float, rate: float, rng) -> np.ndarray:
    n = int(round(rate * length))
    if n < 1:
        return np.empty(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.roll(np.random.default_rng(_ORDER_SEED).permutation(gaps), rng.integers(n))
    c = np.cumsum(gaps) - gaps / 2
    return start + c * (length / c[-1]) * (1 - 0.5 / n)


def schedule(seconds: float, rate: float, seed: int, *, burst_factor: float = 1.0,
             burst_s: float = 0.0, period_s: float | None = None) -> np.ndarray:
    """Due times in seconds from the window's start, ascending, in [0, seconds)."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    period = seconds if period_s is None else period_s
    quiet = period - (burst_s if period_s is not None else 0.0)
    parts = []
    for k in range(math.ceil(seconds / period)):
        t = k * period
        for length, r in ((quiet, rate), (period - quiet, rate * burst_factor)):
            length = min(length, seconds - t)
            if length > 0:
                parts.append(_phase(t, length, r, rng))
            t += length
    due = np.sort(np.concatenate(parts)) if parts else np.empty(0)
    return due[due < seconds]

"""The arithmetic of the end-to-end and per-layer numbers, on the host."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by the nearest-rank
    rule: the smallest value with at least ``q``% of the values at or below
    it. ``inf`` stands for a request that failed or never finished, so it
    lies beyond every finite value; the result is ``inf`` when the rank
    falls on one."""
    if not len(values):
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(units: float, seconds: float) -> float:
    """Units over seconds: all the work of a window over all its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds


def spread(values: Iterable[float]) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    values = list(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def share_of_peak(work_at_peak_s: float, seconds: float) -> Optional[float]:
    """Percent of a window that the work would fill at the card's peaks:
    ``work_at_peak_s`` is the least time the work could take. None when
    there was no work or no time."""
    if work_at_peak_s <= 0 or seconds <= 0:
        return None
    return 100.0 * work_at_peak_s / seconds

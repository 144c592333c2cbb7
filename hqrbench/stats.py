"""Percentiles over raw samples."""

from __future__ import annotations

import statistics


def percentile(values, q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of the raw samples, by linear
    interpolation between the two nearest order statistics (the
    "inclusive" method of ``statistics.quantiles``); no buckets."""
    values = list(values)
    if not values:
        raise ValueError("no samples")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


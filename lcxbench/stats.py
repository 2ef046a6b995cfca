"""Percentiles as the benchmark takes them."""
from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it (an infinite value
    stays one); None for no values."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]

"""Tiny dependency-free order statistics for the serving runtime; a copy
of ``repro.utils.stats``, since the port imports nothing of ``repro``."""
from __future__ import annotations

from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of ``xs`` with linear
    interpolation between order statistics — numpy's default method,
    reimplemented so the serving paths stay stdlib-only."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100]: {q}")
    s = sorted(float(x) for x in xs)
    if not s:
        raise ValueError("percentile of an empty sequence")
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)

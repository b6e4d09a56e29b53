"""A copy of ``boxmot_tpu/utils/fmt.py``.

Shared display formatting helpers.
"""

from __future__ import annotations


def as_percent(v: float) -> float:
    """Normalize a metric to percent for display.

    Metric dicts carry fractions in [-1.5, 1.5] (MOTA is unbounded below
    and can be negative); values outside that band are already percent.
    """
    v = float(v)
    return v * 100.0 if abs(v) <= 1.5 else v

"""A copy of ``boxmot_tpu/trackers/per_class_ids.py``.

Reference-style global sequential track ids for per-class mode
(``GlobalIdAllocator``).
"""

from __future__ import annotations

import numpy as np


class GlobalIdAllocator:
    """Maps class-namespaced raw track ids to global sequential ids."""

    def __init__(self):
        self._map: dict[int, int] = {}
        self._next = 1

    def reset(self) -> None:
        self._map.clear()
        self._next = 1

    def observe_created(self, raw_start: int, raw_stop: int) -> None:
        """Register tracks created this step: raw ids [raw_start, raw_stop)
        in creation order (the banks assign consecutive ids per frame)."""
        for raw in range(int(raw_start), int(raw_stop)):
            if raw not in self._map:
                self._map[raw] = self._next
                self._next += 1

    def remap(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized raw->global translation of an output id column.
        Unseen raw ids (defensive: a tracker emitting ids outside its
        observed creation ranges) are assigned on first appearance."""
        out = np.empty_like(ids)
        for i, v in enumerate(ids):
            raw = int(round(float(v)))
            g = self._map.get(raw)
            if g is None:
                g = self._next
                self._map[raw] = g
                self._next += 1
            out[i] = g
        return out

"""Reference-style global sequential track ids for per-class mode.

The port's own copy of ``GlobalIdAllocator`` from
``boxmot_tpu/trackers/per_class_ids.py``, with the methods the live shell
calls, unchanged.

The reference's per-class split shares one global id counter across all
classes (each tracker type's track class holds a process-wide ``count``
/ ``next_id()`` counter, e.g. basetrack ids for ByteTrack), so a track
created for class 2 after a class-0 track gets the next integer, not an
id from a class-local namespace.  The batched device states keep one id
counter per class bank instead; this allocator reconstructs the reference
numbering on the host by observing how many tracks each class bank created
per frame (classes are processed in ascending order, matching the
reference's ``for cls_id in range(nr_classes)`` loop — reference
trackers/basetracker.py:228).

Creation order — not first-emission order — determines numbering: the
reference increments its counter when a track is *created*, including
tracks that age out before ever being emitted (min_hits gating), so the
allocator must be fed creation counts (``next_id`` deltas), not output
rows.
"""

from __future__ import annotations

import numpy as np


class GlobalIdAllocator:
    """Maps class-namespaced raw track ids to global sequential ids."""

    def __init__(self):
        self._map: dict[int, int] = {}
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

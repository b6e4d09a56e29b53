"""Detection cache paths and per-frame loading.

The port's own copy of ``det_cache_path`` and ``load_cached_dets_per_frame``
from ``boxmot_tpu/data/cache.py``, unchanged.  The cache layout is the
reference's

    <root>/<detector>/dets/<seq>.npy

with detection rows (frame, x1, y1, x2, y2, conf, cls).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def det_cache_path(root: Path, detector: str, seq: str) -> Path:
    return Path(root) / detector / "dets" / f"{seq}.npy"


def load_cached_dets_per_frame(path: Path, n_frames: int):
    """(N, 7) [frame, x1, y1, x2, y2, conf, cls] cache -> per-frame list."""
    rows = np.load(path)
    out = [np.zeros((0, 6), np.float32) for _ in range(n_frames)]
    if rows.size == 0:
        return out
    frames = rows[:, 0].astype(int)
    for f in range(1, n_frames + 1):
        sel = rows[frames == f]
        if len(sel):
            out[f - 1] = sel[:, 1:7].astype(np.float32)
    return out

"""A copy of ``boxmot_tpu/engine/mot_io.py``.

MOT-format result conversion, writing and reading: rows are (frame, id,
left, top, width, height, conf, cls + 1, det_ind) with tlwh rounded to
ints (reference boxmot/engine/tracking/mot.py:239-330).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def convert_to_mot_format(results: np.ndarray, frame_idx: int) -> np.ndarray:
    """(M, 8) tracker output [x1,y1,x2,y2,id,conf,cls,det_ind] -> MOT rows."""
    results = np.asarray(results)
    if results.size == 0:
        return np.empty((0, 9), np.float32)
    xyxy = results[:, :4]
    tlwh = np.stack(
        [xyxy[:, 0], xyxy[:, 1], xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]],
        axis=-1,
    )
    return np.column_stack(
        [
            np.full((len(results), 1), frame_idx, np.int32),
            results[:, 4].reshape(-1, 1).astype(np.int32),
            tlwh.round().astype(np.int32),
            results[:, 5].reshape(-1, 1),
            (results[:, 6] + 1).reshape(-1, 1).astype(np.int32),
            results[:, 7].reshape(-1, 1).astype(np.int32),
        ]
    )


def write_mot_results(txt_path: Path, mot_results: np.ndarray) -> None:
    txt_path = Path(txt_path)
    txt_path.parent.mkdir(parents=True, exist_ok=True)
    fmt = ["%d", "%d", "%d", "%d", "%d", "%d", "%.6f", "%d", "%d"]
    with open(txt_path, "w") as f:
        if mot_results is not None and len(mot_results):
            np.savetxt(f, mot_results, fmt=fmt, delimiter=",")


def read_mot_results(txt_path: Path) -> np.ndarray:
    txt_path = Path(txt_path)
    if not txt_path.exists():
        return np.zeros((0, 9), np.float64)
    rows = np.loadtxt(txt_path, delimiter=",", ndmin=2, dtype=np.float64)
    if rows.size == 0:
        return np.zeros((0, 9), np.float64)
    return rows

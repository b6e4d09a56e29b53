"""A copy of ``boxmot_tpu/postprocessing/gsi.py``.

GSI: gap linear interpolation + Gaussian-process trajectory smoothing.

Port of boxmot/postprocessing/gsi.py:13-143 — operates on MOT rows
(frame, id, x, y, w, h, conf, cls, det_ind).
"""

from __future__ import annotations

import numpy as np

from boxmot_tpu_torch.postprocessing.base import MotFilePostprocessor


def linear_interpolation(data: np.ndarray, interval: int) -> np.ndarray:
    """Insert linearly interpolated rows for same-id frame gaps < interval."""
    sorted_data = data[np.lexsort((data[:, 0], data[:, 1]))]
    rows = []
    prev_id = prev_frame = prev_row = None
    for row in sorted_data:
        frame, tid = int(row[0]), int(row[1])
        if (
            prev_id is not None
            and tid == prev_id
            and prev_frame + 1 < frame < prev_frame + interval
        ):
            gap = frame - prev_frame - 1
            for i in range(1, gap + 1):
                rows.append(prev_row + (row - prev_row) * (i / (frame - prev_frame)))
        rows.append(row)
        prev_id, prev_frame, prev_row = tid, frame, row
    out = np.array(rows)
    return out[np.lexsort((out[:, 0], out[:, 1]))]


def gaussian_smooth(data: np.ndarray, tau: float) -> np.ndarray:
    """GP-smooth columns 2..5 per track id (RBF kernel, gsi.py:57-104)."""
    from sklearn.gaussian_process import GaussianProcessRegressor as GPR
    from sklearn.gaussian_process.kernels import RBF

    out = []
    for obj_id in np.unique(data[:, 1]):
        tracks = data[data[:, 1] == obj_id]
        n = len(tracks)
        length_scale = np.clip(tau * np.log(tau**3 / n), tau**-1, tau**2)
        t = tracks[:, 0].reshape(-1, 1)
        gpr = GPR(RBF(length_scale, length_scale_bounds="fixed"))
        smoothed = gpr.fit(t, tracks[:, 2:6]).predict(t)
        for i in range(n):
            out.append(
                np.concatenate(
                    ([tracks[i, 0], obj_id], smoothed[i], tracks[i, 6:8], [-1])
                )
            )
    return np.array(out)


class GSIPostprocessor(MotFilePostprocessor):
    name = "gsi"

    def __init__(self, interval: int = 20, tau: float = 10):
        self.interval = interval
        self.tau = tau

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        if rows.size == 0:
            return rows
        return gaussian_smooth(linear_interpolation(rows, self.interval), self.tau)


def gsi(mot_results_folder, interval: int = 20, tau: float = 10):
    GSIPostprocessor(interval=interval, tau=tau).run(mot_results_folder)

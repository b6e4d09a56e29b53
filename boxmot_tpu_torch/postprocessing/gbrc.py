"""A copy of ``boxmot_tpu/postprocessing/gbrc.py``.

GBRC: gap interpolation + gradient-boosting-regressor smoothing.

Port of boxmot/postprocessing/gbrc.py:12-200.
"""

from __future__ import annotations

import numpy as np

from boxmot_tpu_torch.postprocessing.base import MotFilePostprocessor
from boxmot_tpu_torch.postprocessing.gsi import linear_interpolation


def gradient_boosting_smooth(
    data: np.ndarray,
    n_estimators: int = 115,
    learning_rate: float = 0.065,
    min_samples_split: int = 6,
) -> np.ndarray:
    from sklearn.ensemble import GradientBoostingRegressor

    if data.size == 0:
        return data
    out = []
    for obj_id in np.unique(data[:, 1]):
        tracks = data[data[:, 1] == obj_id].copy()
        t = tracks[:, 0].reshape(-1, 1)
        # The reference smooths even degenerate short tracks (boosting on
        # <min_samples_split rows collapses to the column mean) "for
        # consistency" — replicate rather than passing them through raw
        # (gbrc.py:75-77).
        for col in (2, 3, 4, 5):
            regr = GradientBoostingRegressor(
                n_estimators=n_estimators,
                learning_rate=learning_rate,
                min_samples_split=min_samples_split,
            )
            tracks[:, col] = regr.fit(t, tracks[:, col]).predict(t)
        out.append(tracks)
    res = np.concatenate(out)
    return res[np.lexsort((res[:, 0], res[:, 1]))]


class GBRCPostprocessor(MotFilePostprocessor):
    name = "gbrc"

    def __init__(
        self,
        interval: int = 20,
        n_estimators: int = 115,
        learning_rate: float = 0.065,
        min_samples_split: int = 6,
    ):
        self.interval = interval
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.min_samples_split = min_samples_split

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        if rows.size == 0:
            return rows
        return gradient_boosting_smooth(
            linear_interpolation(rows, self.interval),
            self.n_estimators,
            self.learning_rate,
            self.min_samples_split,
        )


def gbrc(mot_results_folder, **kwargs):
    GBRCPostprocessor(**kwargs).run(mot_results_folder)

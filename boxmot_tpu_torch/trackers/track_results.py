"""TrackResults: zero-copy ndarray view over tracker output.

The port's own copy of ``boxmot_tpu/trackers/track_results.py``,
unchanged below this paragraph: the live API returns it.

API mirror of the reference boxmot/trackers/track_results.py:12-199.
AABB columns (8): x1, y1, x2, y2, id, conf, cls, det_ind
OBB  columns (9): cx, cy, w, h, angle, id, conf, cls, det_ind
"""

from __future__ import annotations

import csv
import io
import json

import numpy as np


class TrackResults(np.ndarray):
    """Thin zero-copy view with named accessors over (N, 8) / (N, 9)."""

    def __new__(cls, data: np.ndarray, masks: np.ndarray = None) -> "TrackResults":
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim == 1 and arr.size > 0:
            arr = arr.reshape(1, -1)
        elif arr.size == 0:
            cols = arr.shape[1] if arr.ndim == 2 else 0
            arr = arr.reshape(0, cols)
        obj = arr.view(cls)
        obj._masks = masks
        return obj

    def __array_finalize__(self, obj):
        self._masks = getattr(obj, "_masks", None)

    @property
    def masks(self):
        """Segmentation masks for tracked objects, (M, H, W) or None."""
        return self._masks

    @property
    def is_obb(self) -> bool:
        return self.shape[1] >= 9 if self.ndim == 2 else False

    # -- geometry ------------------------------------------------------

    @property
    def xyxy(self) -> np.ndarray:
        if self.is_obb:
            cx, cy, w, h, a = (np.asarray(self[:, i]) for i in range(5))
            ca, sa = np.abs(np.cos(a)), np.abs(np.sin(a))
            ex = w / 2 * ca + h / 2 * sa
            ey = w / 2 * sa + h / 2 * ca
            return np.stack([cx - ex, cy - ey, cx + ex, cy + ey], axis=-1)
        return np.asarray(self[:, :4])

    @property
    def xywh(self) -> np.ndarray:
        if self.is_obb:
            return np.asarray(self[:, :4])
        b = np.asarray(self[:, :4])
        if b.size == 0:
            return np.empty((0, 4), np.float32)
        return np.stack(
            [
                (b[:, 0] + b[:, 2]) / 2,
                (b[:, 1] + b[:, 3]) / 2,
                b[:, 2] - b[:, 0],
                b[:, 3] - b[:, 1],
            ],
            axis=-1,
        )

    @property
    def xywha(self) -> np.ndarray:
        if not self.is_obb:
            xywh = self.xywh
            return np.concatenate(
                [xywh, np.zeros((len(xywh), 1), np.float32)], axis=-1
            )
        return np.asarray(self[:, :5])

    # -- attributes ----------------------------------------------------

    @property
    def _id_col(self) -> int:
        return 5 if self.is_obb else 4

    @property
    def id(self) -> np.ndarray:
        return np.asarray(self[:, self._id_col])

    @property
    def conf(self) -> np.ndarray:
        return np.asarray(self[:, self._id_col + 1])

    @property
    def cls(self) -> np.ndarray:
        return np.asarray(self[:, self._id_col + 2])

    @property
    def det_ind(self) -> np.ndarray:
        return np.asarray(self[:, self._id_col + 3])

    # -- export --------------------------------------------------------

    def _records(self):
        for row in np.asarray(self):
            if self.is_obb:
                cx, cy, w, h, angle, tid, conf, cls_, det_ind = row[:9]
                yield {
                    "cx": float(cx), "cy": float(cy), "w": float(w),
                    "h": float(h), "angle": float(angle), "id": int(tid),
                    "conf": float(conf), "cls": int(cls_), "det_ind": int(det_ind),
                }
            else:
                x1, y1, x2, y2, tid, conf, cls_, det_ind = row[:8]
                yield {
                    "x1": float(x1), "y1": float(y1), "x2": float(x2),
                    "y2": float(y2), "id": int(tid), "conf": float(conf),
                    "cls": int(cls_), "det_ind": int(det_ind),
                }

    def to_json(self) -> str:
        return json.dumps(list(self._records()), indent=2)

    def to_csv(self) -> str:
        records = list(self._records())
        buf = io.StringIO()
        if records:
            writer = csv.DictWriter(buf, fieldnames=list(records[0].keys()))
            writer.writeheader()
            writer.writerows(records)
        return buf.getvalue()

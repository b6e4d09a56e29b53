"""A copy of ``boxmot_tpu/trackers/visualization.py``.

Visualization mixin: draw tracks and trajectories on frames.

API mirror of the reference VisualizationMixin
(boxmot/trackers/common/visualization.py:11-234): `id_to_color` (SHA-256
hue hashing, target-id highlighting), `plot_box_on_img` (solid/dashed
AABB, polygon OBB, id label), `plot_trackers_trajectories` (growing
center dots), and `plot_results`.

The reference iterates live track objects that carry their own
observation deques.  The tracker state here lives on device as struct-
of-arrays, so BaseTracker records a small host-side display history
(id -> deque of output boxes, maxlen 50) from each update()'s results;
plot_results draws the most recent frame's tracks from that history.
Lost-track "predicted" overlays (show_kf_preds): each tracker's step
already computes every slot's KF-predicted box into its (K, cols) out
buffer, so BaseTracker slices the alive-but-unmatched slots
(`_lost_mask`) out of it and plot_results draws them dashed (solid for
OBB, matching the reference style rule,
trackers/common/visualization.py:198,231).
"""

from __future__ import annotations

import colorsys
import hashlib

import numpy as np


class VisualizationMixin:
    def id_to_color(
        self,
        id: int,
        saturation: float = 0.75,
        value: float = 0.95,
        state: str = "confirmed",
    ) -> tuple:
        """Consistent unique BGR color by hashing the id; green for a
        selected target_id, red for removed tracks."""
        if state == "removed":
            return (0, 0, 255)
        target_id = getattr(self, "target_id", None)
        if target_id is not None:
            return (0, 255, 0) if id == target_id else (0, 0, 0)
        digest = hashlib.sha256(str(id).encode()).hexdigest()
        hue = int(digest[:8], 16) / 0xFFFFFFFF
        rgb = colorsys.hsv_to_rgb(hue, saturation, value)
        return tuple(int(c * 255) for c in rgb)[::-1]

    @staticmethod
    def _draw_dashed_rect(img, x1, y1, x2, y2, color, thickness, dash=10, gap=10):
        import cv2 as cv

        for i in range(x1, x2, dash + gap):
            img = cv.line(img, (i, y1), (min(i + dash, x2), y1), color, thickness)
            img = cv.line(img, (i, y2), (min(i + dash, x2), y2), color, thickness)
        for i in range(y1, y2, dash + gap):
            img = cv.line(img, (x1, i), (x1, min(i + dash, y2)), color, thickness)
            img = cv.line(img, (x2, i), (x2, min(i + dash, y2)), color, thickness)
        return img

    @staticmethod
    def _obb_to_polygon(box) -> np.ndarray:
        import cv2 as cv

        arr = np.asarray(box, dtype=np.float32).reshape(-1)
        if arr.size >= 8:
            return arr[:8].reshape(4, 2)
        angle = arr[4] * 180.0 / np.pi
        return cv.boxPoints(((arr[0], arr[1]), (arr[2], arr[3]), angle)).astype(
            np.float32
        )

    def _class_label(self, cls: int) -> str:
        names = getattr(self, "names", None)
        return names.get(int(cls), str(int(cls))) if names else str(int(cls))

    @staticmethod
    def _draw_label(img, label, anchor, fontscale, color, thickness):
        import cv2 as cv

        return cv.putText(
            img, label, anchor, cv.FONT_HERSHEY_SIMPLEX, fontscale, color, thickness
        )

    def plot_box_on_img(
        self,
        img: np.ndarray,
        box,
        conf: float,
        cls: int,
        id: int,
        thickness: int = 2,
        fontscale: float = 0.5,
        state: str = "confirmed",
        style: str = "solid",
    ) -> np.ndarray:
        import cv2 as cv

        color = self.id_to_color(int(id), state=state)
        label = f"id: {int(id)}"
        if getattr(self, "is_obb", False):
            arr = np.asarray(box, np.float32).reshape(-1)
            poly = np.int_(self._obb_to_polygon(arr))
            img = cv.polylines(img, [poly], isClosed=True, color=color, thickness=thickness)
            img = self._draw_label(
                img, label, (int(arr[0]), int(arr[1]) - 10), fontscale, color, thickness
            )
        else:
            x1, y1, x2, y2 = map(int, (box[0], box[1], box[2], box[3]))
            if style == "dashed":
                img = self._draw_dashed_rect(img, x1, y1, x2, y2, color, thickness)
            else:
                img = cv.rectangle(img, (x1, y1), (x2, y2), color, thickness)
            img = self._draw_label(
                img, label, (x1, max(0, y1 - 10)), fontscale, color, thickness
            )
        return img

    def plot_trackers_trajectories(
        self, img: np.ndarray, observations, id: int, state: str = "confirmed"
    ) -> np.ndarray:
        import cv2 as cv

        color = self.id_to_color(int(id), state=state)
        for i, box in enumerate(observations):
            t = int(np.sqrt(float(i + 1)) * 1.2)
            if getattr(self, "is_obb", False):
                center = np.mean(self._obb_to_polygon(box), axis=0)
                cx, cy = int(center[0]), int(center[1])
            else:
                cx = int((box[0] + box[2]) / 2)
                cy = int((box[1] + box[3]) / 2)
            img = cv.circle(img, (cx, cy), 2, color=color, thickness=t)
        return img

    def plot_results(
        self,
        img: np.ndarray,
        show_trajectories: bool,
        thickness: int = 2,
        fontscale: float = 0.5,
        show_kf_preds: bool = False,
    ) -> np.ndarray:
        """Draw every track emitted by the most recent update(); with
        show_kf_preds, also the KF-predicted boxes of currently-lost
        tracks (dashed AABB / solid OBB, reference visualization.py:198)."""
        if not img.flags.writeable:  # e.g. loader-cached frames
            img = img.copy()
        history = getattr(self, "_display_history", {})
        current = getattr(self, "_display_current", ())
        for tid, box, conf, cls in current:
            img = self.plot_box_on_img(
                img, box, conf, cls, tid, thickness=thickness, fontscale=fontscale
            )
            if show_trajectories and tid in history:
                img = self.plot_trackers_trajectories(img, history[tid], tid)
        if show_kf_preds:
            box_cols = 5 if getattr(self, "is_obb", False) else 4
            for rows in getattr(self, "_lost_display_rows", ()):
                for row in np.asarray(rows):
                    tid = int(row[box_cols])
                    img = self.plot_box_on_img(
                        img,
                        row[:box_cols],
                        float(row[box_cols + 1]),
                        int(row[box_cols + 2]),
                        tid,
                        thickness=thickness,
                        fontscale=fontscale,
                        state="predicted",
                        style="dashed",
                    )
                    if show_trajectories and tid in history:
                        img = self.plot_trackers_trajectories(
                            img, history[tid], tid, state="predicted"
                        )
        return img

    # -- history bookkeeping (called by BaseTracker.update) ------------

    def _record_display(self, results, max_obs: int = 50):
        from collections import deque

        if not hasattr(self, "_display_history"):
            self._display_history = {}
        box_cols = 5 if getattr(self, "is_obb", False) else 4
        current = []
        arr = np.asarray(results)
        for row in arr:
            box = row[:box_cols]
            tid = int(row[box_cols])
            conf = float(row[box_cols + 1])
            cls = int(row[box_cols + 2])
            current.append((tid, box, conf, cls))
            self._display_history.setdefault(tid, deque(maxlen=max_obs)).append(box)
        self._display_current = tuple(current)

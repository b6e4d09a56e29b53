"""Detector backend contract (a copy of boxmot_tpu/detectors/base.py).

Mirror of boxmot/detectors/base.py:11-110: a normalized `Detections`
container and a three-stage backend API (preprocess -> process ->
postprocess) so engine code can time and swap stages uniformly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Detections:
    """Normalized detector output (detectors/base.py:11-40)."""

    xyxy: np.ndarray  # (N, 4)
    conf: np.ndarray  # (N,)
    cls: np.ndarray  # (N,)
    masks: np.ndarray | None = None  # (N, H, W)
    is_obb: bool = False
    xywha: np.ndarray | None = None  # (N, 5) when is_obb
    # Pose models: (N, K, 3) keypoints riding alongside the boxes.  The
    # reference adapter tracks pose models through result.boxes alone
    # (ultralytics.py:173-190 extracts no keypoints); carrying them here
    # lets callers re-associate keypoints to tracks via det index.
    keypoints: np.ndarray | None = None

    def as_dets(self) -> np.ndarray:
        """Tracker input layout: (N, 6) AABB or (N, 7) OBB."""
        if self.is_obb:
            return np.column_stack([self.xywha, self.conf, self.cls]).astype(np.float32)
        return np.column_stack([self.xyxy, self.conf, self.cls]).astype(np.float32)

    def __len__(self):
        return len(self.conf)


class BaseDetectorBackend:
    """Three-stage detection API (detectors/base.py:70-110)."""

    def __init__(self, weights=None, device=None, half: bool = False, **kwargs):
        self.weights = weights
        self.device = device
        self.half = half

    def preprocess(self, img: np.ndarray):
        raise NotImplementedError

    def process(self, batch):
        raise NotImplementedError

    def postprocess(self, raw, meta) -> Detections:
        raise NotImplementedError

    def __call__(self, img: np.ndarray) -> Detections:
        batch, meta = self.preprocess(img)
        raw = self.process(batch)
        return self.postprocess(raw, meta)

"""Live detector + ReID inference pipeline (a copy of
boxmot_tpu/engine/inference.py).

Counterpart of the reference DetectorReIDPipeline
(boxmot/engine/tracking/inference.py:40-388): one object owning the
detector backend and the optional ReID extractor, producing per-frame
(dets, embs) for a tracker's update() with

* staged timing (det preprocess/process/postprocess, reid) recorded in a
  shared TimingStats;
* warmup of both models so the first tracked frame is not a compile;
* ReID crop batching with OOM autotune (halve-and-retry on a device
  out-of-memory error, the safe size sticks — inference.py:332-388);
* per-frame failure containment: a detector/reid exception on one frame
  yields an empty detection set instead of aborting the stream
  (reference per-frame exception skip).
"""

from __future__ import annotations

import time

import numpy as np

from boxmot_tpu_torch.utils.autobatch import AutoBatcher
from boxmot_tpu_torch.utils.logging import LOGGER
from boxmot_tpu_torch.utils.timing import TimingStats


class DetectorReIDPipeline:
    def __init__(
        self,
        detector,
        reid=None,
        *,
        batch_size: int = 0,
        auto_batch: bool = True,
        timing: TimingStats | None = None,
        skip_frame_errors: bool = True,
    ):
        """``detector`` is a BaseDetectorBackend (or Detector wrapper);
        ``reid`` an embedder with get_features(xyxy, img)."""
        self.detector = detector
        self.reid = reid
        self.timing = timing if timing is not None else TimingStats()
        self.batcher = AutoBatcher(batch_size, auto=auto_batch) if batch_size else None
        self.skip_frame_errors = skip_frame_errors
        self.frames = 0
        self.failed_frames = 0

    # -- lifecycle -----------------------------------------------------

    def warmup(self, imgsz=(640, 640)):
        dummy = np.zeros((*imgsz, 3), np.uint8)
        try:
            result = self.detector(dummy)
            if self.reid is not None:
                boxes = np.array([[0, 0, 32, 64]], np.float32)
                self.reid.get_features(boxes, dummy)
            return result
        except Exception as exc:  # pragma: no cover - backend-specific
            LOGGER.debug(f"pipeline warmup skipped: {exc}")
            return None

    # -- per-frame -----------------------------------------------------

    def _detect(self, frame):
        t0 = time.perf_counter()
        batch, meta = self.detector.preprocess(frame)
        t1 = time.perf_counter()
        raw = self.detector.process(batch)
        t2 = time.perf_counter()
        result = self.detector.postprocess(raw, meta)
        t3 = time.perf_counter()
        self.timing.add("det_preprocess", t1 - t0)
        self.timing.add("det_process", t2 - t1)
        self.timing.add("det_postprocess", t3 - t2)
        return result

    def _embed(self, dets, frame):
        if self.reid is None or len(dets) == 0:
            return None
        t0 = time.perf_counter()
        boxes = dets[:, :4]
        if self.batcher is not None:
            embs = self.batcher.map(
                lambda b: self.reid.get_features(b, frame), boxes
            )
        else:
            embs = self.reid.get_features(boxes, frame)
        self.timing.add("reid", time.perf_counter() - t0)
        return np.asarray(embs)

    def __call__(self, frame):
        """frame -> (dets (N,6|7) float32, embs (N,D) or None, result).

        ``result`` is the raw Detections (carries masks for seg models).
        """
        self.frames += 1
        try:
            result = self._detect(frame)
            dets = result.as_dets()
            embs = self._embed(dets, frame)
            return dets, embs, result
        except Exception as exc:  # noqa: BLE001 - stream containment
            if not self.skip_frame_errors:
                raise
            self.failed_frames += 1
            LOGGER.warning(
                f"pipeline frame {self.frames} failed ({type(exc).__name__}: "
                f"{exc}); emitting empty detections"
            )
            return np.zeros((0, 6), np.float32), None, None

"""High-level Detector convenience wrapper (a copy of
boxmot_tpu/detectors/detector.py).

Role mirror of boxmot/detectors/detector.py:48-309: wraps any
``BaseDetectorBackend`` with source handling (image / dir / video /
glob via ``iter_source``), event callbacks, warmup, and both eager and
streaming prediction.  ``detector(source)`` returns a list of
``Detections``; ``detector(source, stream=True)`` returns a generator
that yields ``(identifier, frame, Detections)`` lazily so long videos
never materialize in memory.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..data.loaders import iter_source
from ..utils.callbacks import CallbackRegistry
from ..utils.timing import TimingStats
from .base import BaseDetectorBackend, Detections
from .registry import create_detector

EVENTS = (
    "on_predict_start",
    "on_predict_frame_start",
    "on_predict_frame_end",
    "on_predict_end",
)


class Detector:
    """Source-agnostic detection runner with callbacks and timing.

    Parameters mirror the backend factory: ``weights`` picks the backend
    via filename heuristics (detectors/registry.py); an already-built
    backend instance can be passed instead.
    """

    def __init__(
        self,
        weights: str | BaseDetectorBackend,
        *,
        vid_stride: int = 1,
        warmup: bool = False,
        **backend_kwargs,
    ) -> None:
        if isinstance(weights, BaseDetectorBackend):
            self.backend = weights
        else:
            self.backend = create_detector(weights, **backend_kwargs)
        self.vid_stride = vid_stride
        self.callbacks = CallbackRegistry()
        self.timing = TimingStats()
        self.frame_idx = 0
        if warmup:
            self.warmup()

    def add_callback(self, event: str, fn) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown event {event!r}; expected one of {EVENTS}")
        self.callbacks.add(event, fn)

    def warmup(self, imgsz: tuple[int, int] = (640, 640)) -> None:
        """One dummy forward so the first real frame isn't a compile."""
        dummy = np.zeros((*imgsz, 3), dtype=np.uint8)
        try:
            self.backend(dummy)
        except Exception:
            # Backends that need real weights/images may refuse the dummy;
            # warmup is best-effort only.
            pass

    def predict_frame(self, frame: np.ndarray) -> Detections:
        """Run the three backend stages on one frame, timed per stage."""
        import time

        t0 = time.perf_counter()
        batch, meta = self.backend.preprocess(frame)
        t1 = time.perf_counter()
        raw = self.backend.process(batch)
        t2 = time.perf_counter()
        dets = self.backend.postprocess(raw, meta)
        t3 = time.perf_counter()
        self.timing.add("det_preprocess", t1 - t0)
        self.timing.add("det_process", t2 - t1)
        self.timing.add("det_postprocess", t3 - t2)
        return dets

    def stream(self, source) -> Iterator[tuple[object, np.ndarray, Detections]]:
        """Lazy per-frame prediction over any source."""
        self.callbacks.fire("on_predict_start", self)
        self.frame_idx = 0
        for ident, frame in iter_source(source, vid_stride=self.vid_stride):
            self.callbacks.fire("on_predict_frame_start", self, ident)
            dets = self.predict_frame(frame)
            self.frame_idx += 1
            self.callbacks.fire("on_predict_frame_end", self, ident, dets)
            yield ident, frame, dets
        self.callbacks.fire("on_predict_end", self)

    def __call__(self, source, stream: bool = False):
        if isinstance(source, np.ndarray):
            return self.predict_frame(source)
        it = self.stream(source)
        if stream:
            return it
        return [dets for _, _, dets in it]

"""Fused live tracking: detect -> crop -> ReID -> track on the device, with
no host sync inside a frame (counterpart of boxmot_tpu/engine/fused.py).

The staged live loop (``engine/inference.py::DetectorReIDPipeline`` and a
tracker's ``update``) copies the detections and the embeddings to the host
between its stages.  Here one frame is

    upload of the uint8 letterbox -> standardize -> YOLOX forward -> decode
    -> NMS (kernel K6, ``max_dets`` kept) -> padded detection rows -> crops
    of the uint8 letterbox (kernel K5) -> ReID -> the tracker's replay step

all on the device, and nothing in it waits for the device until the caller
reads the emitted rows (``update``; ``update_async`` returns them on the
device).  The host does the letterbox resize (cv2, as the JAX package) and
that final read.  Where the JAX program crops the standardized letterbox
after undoing the standardization (``frame_std * std + mean``, through its
dense interpolation products), K5 crops the uint8 letterbox itself: the
crops differ from JAX's by the rounding of that round trip (about 1e-7 of a
unit), which moves the embeddings by about 1e-6.  The standardization
before the detector gives the bits of the staged ``preprocess``, so the
fused detections equal the staged detector's.  A CUDA graph of the frame is
later work (ROADMAP Queue B).
"""

from __future__ import annotations

import numpy as np
import torch

from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.replay import _to_host, resolve_tracker, wants_embs
from boxmot_tpu_torch.ops.crops import extract_crops
from boxmot_tpu_torch.trackers.track_results import TrackResults


class FusedLiveTracker:
    """Single-pass live tracker on the detector's device.

    detector: ``YoloXDetector``; reid: the ReID facade (``reid/core.py``) on
    the same device, or None for motion-only trackers; tracker_type /
    tracker_params: any device tracker of the zoo, as its replay config;
    max_dets: the frame's static detection capacity (NMS output size).
    """

    def __init__(self, detector, reid=None, tracker_type: str = "occluboost",
                 tracker_params: dict | None = None, max_dets: int = 64):
        self.detector = detector
        self.reid = reid
        self.device = detector.device
        if reid is not None and reid.device != self.device:
            raise ValueError(f"FusedLiveTracker: the ReID model is on {reid.device}, the detector "
                             f"on {self.device}; they must share one device")
        params = dict(tracker_params or {})
        if reid is not None:
            params.setdefault("feat_dim", reid.feature_dim)
            params.setdefault("with_reid", True)
        else:
            params.setdefault("with_reid", False)
        self.cfg = build_replay_config(tracker_type, **params)
        self._init_state, self._step = resolve_tracker(self.cfg)
        self.max_dets = int(max_dets)
        dev, D = self.device, self.max_dets
        self._unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32).to(dev)
        self._det_ind = torch.arange(D, dtype=torch.float32, device=dev)[:, None]
        self._warp = torch.eye(2, 3, dtype=torch.float32, device=dev)[None]
        self._zero_embs = None
        if reid is None and wants_embs(self.cfg):
            self._zero_embs = torch.zeros((1, D, self.cfg.feat_dim), dtype=torch.float32,
                                          device=dev)
        self.reset()

    def reset(self):
        self._state = self._init_state(self.cfg, 1, self.device)
        self.frame_count = 0

    def warmup(self, frame_hw=(720, 1280)):
        """Run one dummy frame (the kernels' first launch, cuDNN's plans),
        then reset the tracker."""
        self.update(np.zeros((*frame_hw, 3), np.uint8))
        self.reset()

    def _upload(self, padded: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(padded)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def frame_inputs(self, frame_u8: torch.Tensor, r: float):
        """The tracker step's inputs of a letterboxed uint8 frame on the
        device: (dets (D, 7) [x1, y1, x2, y2, conf, cls, det_ind] in frame
        coordinates, padding rows a unit box with conf -1; det_valid (D,);
        embs (D, F) unit rows, zero on padding, or None without ReID)."""
        det = self.detector
        boxes, score, cls_id, keep_idx, keep_mask = det.detect(det.standardize(frame_u8),
                                                               self.max_dets)
        idx = torch.clamp(keep_idx, 0, boxes.shape[0] - 1).long()
        boxes_lb = boxes[idx]  # letterbox coordinates, for the crops
        scale = torch.full((1,), r, dtype=torch.float32, device=self.device)
        keep = keep_mask[:, None]
        dets = torch.cat([torch.where(keep, boxes_lb / scale, self._unit),
                          torch.where(keep_mask, score[idx], -1.0)[:, None],
                          cls_id[idx][:, None], self._det_ind], dim=1)
        embs = None
        if self.reid is not None:
            crop_box = torch.where(keep, boxes_lb, self._unit)
            crops = extract_crops(frame_u8, crop_box, self.reid.crop_hw, False, self.reid.dtype)
            embs = torch.where(keep, self.reid._embed(crops), 0.0)
        return dets, keep_mask, embs

    def update_async(self, frame_bgr: np.ndarray):
        """Advance one frame without waiting for the device: (out (K, 8),
        out_mask (K,)) on the device."""
        padded, r = self.detector.preprocess_u8(frame_bgr)
        dets, valid, embs = self.frame_inputs(self._upload(padded), r)
        embs = self._zero_embs if embs is None else embs[None]
        self._state, out, mask = self._step(self.cfg, self._state, dets[None], valid[None], embs,
                                            self._warp)
        self.frame_count += 1
        return out[0], mask[0]

    def update(self, frame_bgr: np.ndarray) -> TrackResults:
        """frame -> TrackResults; the emitted rows are the one read back."""
        out, mask = _to_host(*self.update_async(frame_bgr))
        return TrackResults(out[mask])

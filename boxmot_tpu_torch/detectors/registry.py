"""Detector registry and the YOLOX backend (counterpart of
boxmot_tpu/detectors/registry.py).

``get_detector_class`` maps weights to a backend by file name as the JAX
registry does: ``yolox*`` to ``YoloXDetector``, ``rtdetr*`` / ``rt-detr*``
to ``RTDetrDetector``, anything else to ``UltralyticsDetector``.  The port
runs YOLOX and the vendored ``yololite*`` predictor
(``detectors/yolo_lite.py``) on the card.  Any other ultralytics stem needs
the ``ultralytics`` package and RT-DETR needs ``transformers``; where they
are absent the adapters raise the JAX package's ``ImportError``s.
``PublicDetections`` replays per-frame detections, as in JAX.

``YoloXDetector`` keeps the three-stage contract of ``BaseDetectorBackend``:
``preprocess(img)`` returns ``(batch, r)`` (the letterboxed, standardized
float32 image and its scale), ``process(batch)`` runs the forward pass, the
decode and NMS (kernel K6) on the device, and ``postprocess(raw, r)`` maps
the kept boxes back to the frame.  (The JAX class returns ``(batch, r)``
from ``preprocess`` too, but its ``process`` unpacks the pair itself, so
its own staged callers, ``Detector.predict_frame`` and
``DetectorReIDPipeline``, hand it the bare array and fail; the port's
stages compose.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from boxmot_tpu_torch.detectors.base import BaseDetectorBackend, Detections
from boxmot_tpu_torch.detectors.yolo_lite import LiteYOLO
from boxmot_tpu_torch.models.convert import load_yolox
from boxmot_tpu_torch.models.yolox import build_yolox
from boxmot_tpu_torch.ops.crops import IMAGENET_MEAN, IMAGENET_STD
from boxmot_tpu_torch.ops.nms import nms, yolox_decode
from boxmot_tpu_torch.utils.device import resolve_device


class PublicDetections(BaseDetectorBackend):
    """Replays per-frame public detections (det.txt) as a detector."""

    def __init__(self, dets_per_frame, **kwargs):
        super().__init__(**kwargs)
        self.dets_per_frame = dets_per_frame
        self._frame = 0

    def preprocess(self, img):
        return img, None

    def process(self, batch):
        idx = self._frame
        self._frame += 1
        if idx < len(self.dets_per_frame):
            return self.dets_per_frame[idx]
        return np.zeros((0, 6), np.float32)

    def postprocess(self, raw, meta) -> Detections:
        return Detections(xyxy=raw[:, :4], conf=raw[:, 4], cls=raw[:, 5])


def _as_numpy(values) -> np.ndarray:
    """Torch tensors (cuda or cpu) and arrays -> float32 numpy
    (reference boxmot/detectors/ultralytics.py:151-156)."""
    if hasattr(values, "cpu"):
        values = values.cpu()
    if hasattr(values, "numpy"):
        values = values.numpy()
    return np.asarray(values, dtype=np.float32)


class UltralyticsDetector(BaseDetectorBackend):
    """Adapter over the ultralytics YOLO predictor (a copy of the JAX
    package's; reference boxmot/detectors/ultralytics.py:17-204), covering
    all three result families the reference extracts:

      * detect models  -> result.boxes  {xyxy, conf, cls}
      * segment models -> result.boxes + result.masks.data (binarized
        at 0.5 to uint8, ultralytics.py:183-189)
      * OBB models     -> result.obb {xywhr, conf, cls} -> (N,7) dets
        (ultralytics.py:166-172)
      * pose models    -> result.boxes as usual (the reference tracks
        pose models through their boxes, ci.yml:398-424) + keypoints
        carried on Detections.keypoints for track re-association
    """

    def __init__(self, weights, device="cuda", half=False, conf=0.25,
                 iou=0.7, classes=None, agnostic_nms=False, **kwargs):
        super().__init__(weights, device, half)
        if Path(str(weights)).stem.lower().startswith("yololite"):
            # vendored offline predictor with the same result surface, on
            # ``device`` (the card unless the caller asks for the CPU)
            self.model = LiteYOLO(str(weights), device=device)
        else:
            try:
                from ultralytics import YOLO  # noqa: PLC0415
            except ImportError as exc:
                raise ImportError(
                    "ultralytics is not installed in this environment; install "
                    "it, use the vendored predictor (--detector yololite[-seg|"
                    "-obb|-pose]), or replay cached detections "
                    "(--detector public)"
                ) from exc
            self.model = YOLO(str(weights))
        self.conf = conf
        self.iou = iou
        self.classes = classes
        self.agnostic_nms = agnostic_nms

    def preprocess(self, img):
        return img, None

    def process(self, batch):
        kwargs = {"conf": self.conf, "verbose": False}
        # only pass non-default knobs: recorded fakes and older
        # predictor signatures need not accept every option
        if self.iou != 0.7:
            kwargs["iou"] = self.iou
        if self.classes is not None:
            kwargs["classes"] = self.classes
        if self.agnostic_nms:
            kwargs["agnostic_nms"] = True
        return self.model.predict(batch, **kwargs)[0]

    def postprocess(self, raw, meta) -> Detections:
        obb = getattr(raw, "obb", None)
        if obb is not None:
            if len(obb) == 0:
                return Detections(
                    xyxy=np.zeros((0, 4), np.float32),
                    conf=np.zeros((0,), np.float32),
                    cls=np.zeros((0,), np.float32),
                    is_obb=True,
                    xywha=np.zeros((0, 5), np.float32),
                )
            xywhr = _as_numpy(obb.xywhr)
            conf = _as_numpy(obb.conf).reshape(-1)
            cls = _as_numpy(obb.cls).reshape(-1)
            # axis-aligned hull of the rotated rect (host numpy)
            cx, cy, w, h, a = xywhr.T
            ex = np.abs(w / 2 * np.cos(a)) + np.abs(h / 2 * np.sin(a))
            ey = np.abs(w / 2 * np.sin(a)) + np.abs(h / 2 * np.cos(a))
            xyxy = np.stack(
                [cx - ex, cy - ey, cx + ex, cy + ey], axis=1
            ).astype(np.float32)
            return Detections(
                xyxy=xyxy, conf=conf, cls=cls, is_obb=True, xywha=xywhr
            )

        boxes = raw.boxes
        if boxes is None or len(boxes) == 0:
            return Detections(
                xyxy=np.zeros((0, 4), np.float32),
                conf=np.zeros((0,), np.float32),
                cls=np.zeros((0,), np.float32),
            )
        masks = None
        raw_masks = getattr(raw, "masks", None)
        if raw_masks is not None and len(raw_masks) > 0:
            masks = (_as_numpy(raw_masks.data) > 0.5).astype(np.uint8)
        keypoints = None
        raw_kpts = getattr(raw, "keypoints", None)
        if raw_kpts is not None and len(raw_kpts) > 0:
            keypoints = _as_numpy(raw_kpts.data)  # (N, K, 3)
        return Detections(
            xyxy=_as_numpy(boxes.xyxy),
            conf=_as_numpy(boxes.conf).reshape(-1),
            cls=_as_numpy(boxes.cls).reshape(-1),
            masks=masks,
            keypoints=keypoints,
        )


class RTDetrDetector(BaseDetectorBackend):
    """HF-transformers RT-DETR adapter (the JAX package's body;
    detectors/rtdetr.py:15) on ``device``, the card unless the caller asks
    for the CPU: the model and the processor's tensors live there, and the
    kept rows come back to the host."""

    def __init__(self, weights, device="cuda", half=False, conf=0.5, **kwargs):
        super().__init__(weights, device, half)
        try:
            from transformers import AutoModelForObjectDetection, AutoImageProcessor  # noqa: PLC0415
        except ImportError as exc:
            raise ImportError("transformers is required for RT-DETR") from exc
        self.device = resolve_device(device)
        self.processor = AutoImageProcessor.from_pretrained(str(weights))
        self.model = AutoModelForObjectDetection.from_pretrained(str(weights)).to(self.device)
        self.conf = conf

    def preprocess(self, img):
        inputs = self.processor(images=img[..., ::-1], return_tensors="pt")
        return {k: v.to(self.device) for k, v in inputs.items()}, img.shape[:2]

    def process(self, batch):
        with torch.no_grad():
            return self.model(**batch)

    def postprocess(self, raw, meta) -> Detections:
        res = self.processor.post_process_object_detection(
            raw, threshold=self.conf,
            target_sizes=torch.tensor([meta], device=self.device)
        )[0]
        return Detections(
            xyxy=_as_numpy(res["boxes"]),
            conf=_as_numpy(res["scores"]),
            cls=_as_numpy(res["labels"]),
        )


def letterbox_u8(img: np.ndarray, imgsz):
    """ByteTrack's letterbox of a uint8 BGR frame: cv2's bilinear resize to
    fit ``imgsz`` (h, w), padded with 114 -> ((h, w, 3) uint8, scale)."""
    import cv2

    ih, iw = imgsz
    r = min(ih / img.shape[0], iw / img.shape[1])
    resized = cv2.resize(img, (int(img.shape[1] * r), int(img.shape[0] * r)),
                         interpolation=cv2.INTER_LINEAR)
    padded = np.full((ih, iw, 3), 114, np.uint8)
    padded[: resized.shape[0], : resized.shape[1]] = resized
    return padded, r


def standardize_host(padded_u8: np.ndarray) -> np.ndarray:
    """A letterboxed uint8 BGR frame -> the detector's float32 input: RGB,
    / 255, then ImageNet standardization.  As in the JAX package's
    ``preprocess``, the standardization runs in float64 (the mean and std
    tuples promote it) and rounds once."""
    rgb = padded_u8.astype(np.float32)[:, :, ::-1] / 255.0
    return ((rgb - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


class YoloXDetector(BaseDetectorBackend):
    """YOLOX on ``device`` (the card unless the caller asks for the CPU):
    host letterbox, then forward, decode and NMS on the device.  Weights are
    yolox torch checkpoints (``models/convert.py::load_yolox``); without a
    weights file the net has seeded random weights (shape and speed work
    only).  ``half`` runs the forward in bf16; decode and NMS stay float32."""

    MAX_DETS = 256

    def __init__(self, weights, device="cuda", half: bool = False, imgsz=(800, 1440),
                 conf: float = 0.01, iou: float = 0.7, num_classes: int = 1, **kwargs):
        super().__init__(weights, device, half)
        self.device = resolve_device(device)
        vals = imgsz if isinstance(imgsz, (list, tuple)) else (imgsz,)
        h, w = (tuple(vals) * 2)[:2]
        self.imgsz = (int(h), int(w))
        self.conf = float(conf)
        self.iou = float(iou)
        name = Path(str(weights)).stem if weights is not None else "yolox_x"
        # a seeded initialization that leaves the global generator alone
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_yolox(name, num_classes=num_classes)
        if weights is not None and Path(str(weights)).exists():
            model.load_state_dict(load_yolox(str(weights), name), strict=True)
        self.dtype = torch.bfloat16 if half else torch.float32
        self.model = model.eval().to(device=self.device, dtype=self.dtype)
        dev = self.device
        self._conf_t = torch.full((), self.conf, dtype=torch.float32, device=dev)
        self._255 = torch.full((), 255.0, dtype=torch.float32, device=dev)
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64).to(dev)
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float64).to(dev)

    def preprocess(self, img: np.ndarray):
        """Letterbox and standardize on the host: (float32 (h, w, 3) array,
        scale)."""
        padded, r = letterbox_u8(img, self.imgsz)
        return standardize_host(padded), r

    def preprocess_u8(self, img: np.ndarray):
        """The letterbox alone, uint8 (a quarter of the float32 image's bytes
        to upload); ``standardize`` finishes it on the device."""
        return letterbox_u8(img, self.imgsz)

    def standardize(self, frame_u8: torch.Tensor) -> torch.Tensor:
        """A letterboxed uint8 BGR frame on the device -> what ``preprocess``
        computes on the host, bit for bit: RGB, / 255 in float32 (by a
        tensor), then (x - mean) / std in float64, rounded once."""
        rgb = frame_u8.flip(-1).to(torch.float32) / self._255
        return ((rgb.double() - self._mean) / self._std).to(torch.float32)

    @torch.no_grad()
    def detect(self, img: torch.Tensor, max_dets: int | None = None):
        """A standardized (h, w, 3) float32 image on the device -> (boxes (N,
        4) letterbox xyxy, score (N,), cls_id (N,), keep_idx (max_dets,),
        keep_mask (max_dets,)), all on the device, with no host sync;
        ``max_dets`` is ``MAX_DETS`` unless given."""
        x = img.permute(2, 0, 1)[None].to(self.dtype)
        raw = self.model(x)[0].to(torch.float32)
        boxes, obj, cls = yolox_decode(raw, img_hw=self.imgsz)
        cls_conf = cls.max(dim=-1).values
        cls_id = torch.argmax(cls, dim=-1).to(torch.float32)
        score = obj * cls_conf  # conf = obj * class (yolox.py:258)
        masked = torch.where(score >= self._conf_t, score, torch.full_like(score, -1.0))
        keep_idx, keep_mask = nms(boxes, masked, self.iou, max_dets or self.MAX_DETS)
        return boxes, score, cls_id, keep_idx, keep_mask

    def process(self, batch):
        """``preprocess``'s image -> ``detect``'s tensors (one upload)."""
        img = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":
            img = img.pin_memory().to(self.device, non_blocking=True)
        return self.detect(img)

    def postprocess(self, raw, meta) -> Detections:
        """The kept rows, boxes divided by the letterbox scale ``meta``."""
        boxes, score, cls_id, keep_idx, keep_mask = raw
        idx = torch.clamp_min(keep_idx, 0).long()
        rows = torch.cat([boxes[idx], score[idx, None], cls_id[idx, None]], dim=1)
        rows, mask = rows.cpu().numpy(), keep_mask.cpu().numpy()
        kept = rows[mask]
        return Detections(xyxy=kept[:, :4] / np.float32(meta), conf=kept[:, 4], cls=kept[:, 5])


def get_detector_class(weights) -> type[BaseDetectorBackend]:
    stem = Path(str(weights)).stem.lower()
    if stem.startswith("yolox"):
        return YoloXDetector
    if stem.startswith("rtdetr") or stem.startswith("rt-detr"):
        return RTDetrDetector
    return UltralyticsDetector


def create_detector(weights, **kwargs) -> BaseDetectorBackend:
    return get_detector_class(weights)(weights=weights, **kwargs)

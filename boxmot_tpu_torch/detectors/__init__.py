"""Detector adapters: normalized Detections + backend registry."""

from boxmot_tpu_torch.detectors.base import BaseDetectorBackend, Detections  # noqa: F401
from boxmot_tpu_torch.detectors.registry import create_detector, get_detector_class  # noqa: F401

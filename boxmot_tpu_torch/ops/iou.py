"""Pairwise IoU (counterpart of boxmot_tpu/ops/iou.py::iou_batch).

Plain PyTorch only: it is the reference for the IoU output of the fused
IoU + cost kernel (``ops/fused_iou_cost.py``), which the tracker step
calls instead.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def iou_batch(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) IoU, union clamped at 1e-12."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    xx1 = torch.maximum(b1[..., 0], b2[..., 0])
    yy1 = torch.maximum(b1[..., 1], b2[..., 1])
    xx2 = torch.minimum(b1[..., 2], b2[..., 2])
    yy2 = torch.minimum(b1[..., 3], b2[..., 3])
    wh = torch.clamp_min(xx2 - xx1, 0.0) * torch.clamp_min(yy2 - yy1, 0.0)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = area1 + area2 - wh
    return wh / torch.clamp_min(union, _EPS)

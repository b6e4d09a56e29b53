# Frozen copy of boxmot_tpu_torch/ops/iou.py at commit 78364f93b578: the plain
# (twin) path only, on every device; no kernel, no tracker shell.
"""Pairwise box similarities for association (counterpart of
boxmot_tpu/ops/iou.py).

Every function maps (S, N, 4) x (S, M, 4) xyxy boxes (or (S, N, 5) x
(S, M, 5) [cx, cy, w, h, theta] for the ``_obb`` ones) to an (S, N, M)
similarity in [0, 1], with the JAX function's operations in its order.
``iou_batch`` and the rest are plain PyTorch; ``get_asso_func`` resolves a
name as the JAX function does, except that ``"iou"`` resolves to kernel K1
in its IoU-only mode with ``iou_batch``'s union clamp (bit-equal to
``iou_batch``) and ``"iou_obb"`` to kernel K3, which the tracker steps then
launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.frozen.ops.fused_iou_cost import IOU_BATCH_EPS, fused_iou_cost
from portbench.reference.frozen.ops.geometry import exact
from portbench.reference.frozen.ops.rotated_iou import iou_batch_obb, rotated_iou  # noqa: F401 (re-export)

_EPS = IOU_BATCH_EPS


def _pairs(boxes1, boxes2):
    return boxes1[..., :, None, :], boxes2[..., None, :, :]


def _inter_area(b1, b2):
    xx1 = torch.maximum(b1[..., 0], b2[..., 0])
    yy1 = torch.maximum(b1[..., 1], b2[..., 1])
    xx2 = torch.minimum(b1[..., 2], b2[..., 2])
    yy2 = torch.minimum(b1[..., 3], b2[..., 3])
    return torch.clamp_min(xx2 - xx1, 0.0) * torch.clamp_min(yy2 - yy1, 0.0)


def _areas(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _enclosing(b1, b2):
    """Width and height of the pairs' enclosing boxes."""
    w = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    h = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    return w, h


def _centre_dist2(b1, b2):
    cx1 = (b1[..., 0] + b1[..., 2]) / 2.0
    cy1 = (b1[..., 1] + b1[..., 3]) / 2.0
    cx2 = (b2[..., 0] + b2[..., 2]) / 2.0
    cy2 = (b2[..., 1] + b2[..., 3]) / 2.0
    dx, dy = cx1 - cx2, cy1 - cy2
    return dx * dx + dy * dy


def iou_batch(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, union clamped at 1e-12."""
    b1, b2 = _pairs(boxes1, boxes2)
    wh = _inter_area(b1, b2)
    union = _areas(b1) + _areas(b2) - wh
    return wh / torch.clamp_min(union, _EPS)


def hmiou_batch(boxes1, boxes2):
    """Height-modulated IoU: the IoU times the vertical overlap ratio."""
    b1, b2 = _pairs(boxes1, boxes2)
    inter_h = torch.clamp_min(
        torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1]), 0.0)
    union_h = torch.clamp_min(
        torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1]), 1e-10)
    o = inter_h / union_h
    wh = _inter_area(b1, b2)
    union = _areas(b1) + _areas(b2) - wh
    return wh / (union + 1e-10) * o


def giou_batch(boxes1, boxes2):
    """Generalized IoU rescaled to [0, 1]."""
    b1, b2 = _pairs(boxes1, boxes2)
    wh = _inter_area(b1, b2)
    union = _areas(b1) + _areas(b2) - wh
    iou = wh / torch.clamp_min(union, _EPS)
    wc, hc = _enclosing(b1, b2)
    area_enclose = torch.clamp_min(wc * hc, _EPS)
    giou = iou - (area_enclose - union) / area_enclose
    return (giou + 1.0) / 2.0


def diou_batch(boxes1, boxes2):
    """Distance IoU rescaled to [0, 1]."""
    b1, b2 = _pairs(boxes1, boxes2)
    wh = _inter_area(b1, b2)
    union = _areas(b1) + _areas(b2) - wh
    iou = wh / torch.clamp_min(union, _EPS)
    inner_diag = _centre_dist2(b1, b2)
    ow, oh = _enclosing(b1, b2)
    outer_diag = torch.clamp_min(ow * ow + oh * oh, _EPS)
    diou = iou - inner_diag / outer_diag
    return (diou + 1.0) / 2.0


def ciou_batch(boxes1, boxes2):
    """Complete IoU rescaled to [0, 1]."""
    eps = 1e-7
    b1, b2 = _pairs(boxes1, boxes2)
    wh = _inter_area(b1, b2)
    iou = wh / (_areas(b1) + _areas(b2) - wh + eps)
    inner_diag = _centre_dist2(b1, b2)
    ow, oh = _enclosing(b1, b2)
    outer_diag = ow * ow + oh * oh + eps
    w1 = b1[..., 2] - b1[..., 0]
    h1 = b1[..., 3] - b1[..., 1] + eps
    w2 = b2[..., 2] - b2[..., 0]
    h2 = b2[..., 3] - b2[..., 1] + eps
    arctan_diff = exact(torch.atan, w2 / h2) - exact(torch.atan, w1 / h1)
    v = (4.0 / (math.pi ** 2)) * (arctan_diff * arctan_diff)
    alpha = v / (1.0 - iou + v + eps)
    ciou = iou - (inner_diag / outer_diag) + alpha * v
    return (ciou + 1.0) / 2.0


def _frame_norm(w: float, h: float) -> float:
    """sqrt(w^2 + h^2) of the frame size in float32, as the JAX functions
    take it."""
    w32, h32 = np.float32(w), np.float32(h)
    return float(np.sqrt(w32 * w32 + h32 * h32))


def centroid_batch(boxes1, boxes2, w, h):
    """1 - the centre distance over the frame diagonal."""
    c1x = (boxes1[..., :, None, 0] + boxes1[..., :, None, 2]) / 2
    c1y = (boxes1[..., :, None, 1] + boxes1[..., :, None, 3]) / 2
    c2x = (boxes2[..., None, :, 0] + boxes2[..., None, :, 2]) / 2
    c2y = (boxes2[..., None, :, 1] + boxes2[..., None, :, 3]) / 2
    dx, dy = c1x - c2x, c1y - c2y
    dist = exact(torch.sqrt, dx * dx + dy * dy)
    # a divisor tensor: a CUDA division by a Python scalar multiplies by its reciprocal
    return 1.0 - dist / torch.full_like(dist, _frame_norm(w, h))


def centroid_batch_obb(obbs1, obbs2, w, h):
    """Centroid similarity of [cx, cy, w, h, theta] boxes."""
    dx = obbs1[..., :, None, 0] - obbs2[..., None, :, 0]
    dy = obbs1[..., :, None, 1] - obbs2[..., None, :, 1]
    dist = exact(torch.sqrt, dx * dx + dy * dy)
    return 1.0 - dist / torch.full_like(dist, _frame_norm(w, h))


def _iou_k1(boxes1, boxes2):
    return fused_iou_cost(boxes1, boxes2, eps=IOU_BATCH_EPS)[0]


ASSO_FUNCS = {
    "iou": _iou_k1,
    "iou_obb": rotated_iou,
    "hmiou": hmiou_batch,
    "giou": giou_batch,
    "ciou": ciou_batch,
    "diou": diou_batch,
}

# functions that also need the frame size
ASSO_FUNCS_WH = {
    "centroid": centroid_batch,
    "centroid_obb": centroid_batch_obb,
}


def get_asso_func(name: str, w: float | None = None, h: float | None = None):
    """Resolve an association similarity by name; the centroid ones are
    closed over the frame size."""
    if name in ASSO_FUNCS:
        return ASSO_FUNCS[name]
    if name in ASSO_FUNCS_WH:
        fn = ASSO_FUNCS_WH[name]
        if w is None or h is None:
            raise ValueError(f"asso func {name!r} requires frame w/h")
        return lambda b1, b2: fn(b1, b2, w, h)
    raise ValueError(
        f"Invalid association mode: {name}. Choose from "
        f"{sorted([*ASSO_FUNCS, *ASSO_FUNCS_WH])}"
    )

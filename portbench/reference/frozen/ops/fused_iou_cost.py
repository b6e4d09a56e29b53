# Frozen copy of boxmot_tpu_torch/ops/fused_iou_cost.py at commit 78364f93b578: the plain
# (twin) path only, on every device; no kernel, no tracker shell.
"""Fused pairwise IoU + fused-score cost: kernel K1 and its plain twin.

``fused_iou_cost`` is the counterpart of the TPU kernel
``boxmot_tpu/ops/pallas_kernels.py::_fused_iou_cost_pallas`` (B1).  On a
CUDA tensor it launches the hand-written kernel ``csrc/iou_cost.cu``; on a
CPU tensor it runs ``fused_iou_cost_plain``, the same arithmetic in plain
PyTorch.  The tracker steps call it for the association IoU and cost, and
in its IoU-only mode (no ``conf``) for ByteTrack's duplicate-suppression IoU
and OC-SORT's association IoU.

The union clamp ``eps`` is an argument.  Its default, 1e-9, is the TPU
kernel's; the tracker steps pass ``IOU_BATCH_EPS`` (1e-12), the clamp of
``iou_batch``, which the JAX tracker steps use: the two clamps give other
IoUs on boxes whose union is below 1e-9.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


THREADS = 512  # the most threads a block of K1 has
TPU_KERNEL_EPS = 1e-9  # the TPU kernel's union clamp
IOU_BATCH_EPS = 1e-12  # iou_batch's union clamp, which the tracker steps use


def fused_iou_cost_plain(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor | None = None,
                         eps: float = TPU_KERNEL_EPS):
    """(S, K, 4), (S, D, 4) xyxy and (S, D) conf -> (iou, 1 - iou*conf), both
    (S, K, D); (iou, None) without conf.

    Same operation order as the TPU kernel, union clamped at ``eps``.
    """
    t = trk[:, :, None, :]
    d = det[:, None, :, :]
    xx1 = torch.maximum(t[..., 0], d[..., 0])
    yy1 = torch.maximum(t[..., 1], d[..., 1])
    xx2 = torch.minimum(t[..., 2], d[..., 2])
    yy2 = torch.minimum(t[..., 3], d[..., 3])
    inter = torch.clamp_min(xx2 - xx1, 0.0) * torch.clamp_min(yy2 - yy1, 0.0)
    area_t = (trk[..., 2] - trk[..., 0]) * (trk[..., 3] - trk[..., 1])
    area_d = (det[..., 2] - det[..., 0]) * (det[..., 3] - det[..., 1])
    iou = inter / torch.clamp_min(area_t[:, :, None] + area_d[:, None, :] - inter, eps)
    return iou, None if conf is None else 1.0 - iou * conf[:, None, :]


def _check(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor | None, eps: float):
    """One pass over the arguments; returns (S, K, D)."""
    if not eps > 0.0:
        raise ValueError(f"fused_iou_cost: eps must be > 0, got {eps}")
    if trk.dim() != 3 or trk.shape[2] != 4:
        raise ValueError(f"fused_iou_cost: trk must be (S, K, 4), got {tuple(trk.shape)}")
    S, K, _ = trk.shape
    if det.dim() != 3 or det.shape[0] != S or det.shape[2] != 4:
        raise ValueError(f"fused_iou_cost: det must be (S, D, 4), got {tuple(det.shape)}")
    D = det.shape[1]
    if conf is not None and tuple(conf.shape) != (S, D):
        raise ValueError(f"fused_iou_cost: conf must be (S, D), got {tuple(conf.shape)}")
    for name, t in (("trk", trk), ("det", det), ("conf", conf)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"fused_iou_cost: {name} must be float32, got {t.dtype}")
        if t.device != trk.device:
            raise ValueError(f"fused_iou_cost: {name} is on {t.device}, trk on {trk.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_iou_cost: {name} must be contiguous")
    return S, K, D


def fused_iou_cost(trk: torch.Tensor, det: torch.Tensor, conf: torch.Tensor | None = None,
                   eps: float = TPU_KERNEL_EPS):
    """(iou, cost) as ``fused_iou_cost_plain`` on every device."""
    _check(trk, det, conf, eps)
    return fused_iou_cost_plain(trk, det, conf, eps)


fused_iou_cost.launches = 0


